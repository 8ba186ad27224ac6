"""Closure-safe pickling wrapper (reference: vidgen/utils/serialize.py:4-29).

The reference needs cloudpickle to ship lambdas into dataloader worker
processes. Our loaders are thread-based (no pickling), but the wrapper is
kept for API parity and for anyone spawning their own processes.
"""



class PicklableWrapper:
    def __init__(self, obj):
        self._obj = obj

    def __reduce__(self):
        try:
            import cloudpickle

            payload = cloudpickle.dumps(self._obj)
            return (_unpickle_cloud, (payload,))
        except ImportError:
            return (PicklableWrapper, (self._obj,))

    def __call__(self, *args, **kwargs):
        return self._obj(*args, **kwargs)

    def __getattr__(self, attr):
        if attr not in ("_obj",):
            return getattr(self._obj, attr)
        return getattr(super(), attr)


def _unpickle_cloud(payload):
    import cloudpickle

    return PicklableWrapper(cloudpickle.loads(payload))
