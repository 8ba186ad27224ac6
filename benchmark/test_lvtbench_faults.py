"""A whole run of a tiny cell on the CPU (the look for a card skipped), with
the timed path broken underneath: ``correct`` comes out false for each
fault the cell can have. Unbroken, it comes out true."""

import time

import pytest
import torch

from lvtbench import runner

SEED = 3 * 2 ** 31 + 5


def _run(cell):
    out, _, bad = runner.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert bad == []
    return out


@pytest.mark.parametrize("kind", ["generate", "train"])
def test_sound_run_is_correct(tiny, kind):
    out = _run(tiny(kind))
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0, out["checks"]


def test_token_altered_where_produced(tiny, monkeypatch):
    from lvt_tpu_torch.models.vt import VideoTransformer

    sample = VideoTransformer.sample_video

    def altered(self, *a, **k):
        out = sample(self, *a, **k)
        out[:, 0, -1, 0, 0] = (out[:, 0, -1, 0, 0] + 1) % self.c.nv
        return out

    monkeypatch.setattr(VideoTransformer, "sample_video", altered)
    assert not _run(tiny("generate"))["correct"]


def test_half_the_batch_left_out_of_the_rollout(tiny, monkeypatch):
    from lvt_tpu_torch.models.vt import VideoTransformer

    sample = VideoTransformer.sample_video

    def half(self, params, video, *a, **k):
        out = video.clone()
        b = video.shape[0] // 2
        out[:b] = sample(self, params, video[:b], *a, **k)
        return out

    monkeypatch.setattr(VideoTransformer, "sample_video", half)
    assert not _run(tiny("generate"))["correct"]


def test_tokens_drawn_from_another_stream(tiny, monkeypatch):
    """The check replays each batch's draws: a rollout that samples from
    other numbers than its batch's generator gives fails it."""
    from lvtbench import traffic

    seeded = traffic.sampling_generator
    monkeypatch.setattr(traffic, "sampling_generator",
                        lambda seed, i, device: seeded(seed + 1, i, device))
    assert not _run(tiny("generate"))["correct"]


def test_step_returns_its_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.RMSprop, "step", lambda self, closure=None: None)
    assert not _run(tiny("train"))["correct"]


def test_half_the_batch_left_out_of_the_loss(tiny, monkeypatch):
    from lvt_tpu_torch.models.vt import VideoTransformer

    loss = VideoTransformer.loss

    def half(self, params, batch, gen=None, **k):
        b = batch["video"].shape[0] // 2
        idx = self.sample_train_slice_idx(gen, 2 * b)[:b]
        return loss(self, params, {"video": batch["video"][:b]}, slice_idx=idx)

    monkeypatch.setattr(VideoTransformer, "loss", half)
    assert not _run(tiny("train"))["correct"]


def test_token_altered_in_the_batch(tiny, monkeypatch):
    from lvt_tpu_torch.engine.trainer import Trainer

    put = Trainer._put_batch

    def altered(self, batch):
        out = put(self, batch)
        out["video"][0, 0, -1, -1, -1] = (out["video"][0, 0, -1, -1, -1] + 1) % 16
        return out

    monkeypatch.setattr(Trainer, "_put_batch", altered)
    assert not _run(tiny("train"))["correct"]
