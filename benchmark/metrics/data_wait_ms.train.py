"""The trainer's wait for its data a step, milliseconds (layer: the trainer's
entry, the loader and ``_put_batch``): ``Trainer.run_step``'s own
``data_time`` (the host clock around the next host batch and its copy to the
card), averaged over the window's steps."""


def read(r):
    data = r.layer.get("data_time")
    if not data:
        return None
    return 1e3 * sum(data) / len(data)
