"""The frozen counts against the numbers the records state: kernel 2's
bound at b = 16, 256 live rows, 0.0050 ms; kernels 7, 8 and 9 at nb = 64
(DSFVT's b64 step: n 256, d 512, 8 heads of 128), 0.1042, 0.0434 and
0.2432 ms, all bf16 (PERF.md's kernel table)."""

import pytest

from lvtbench import cells, peaks


def test_peaks():
    assert peaks.PEAK_BYTES == 3.35e12 and peaks.PEAK_FLOPS["bfloat16"] == 989e12


def test_decode_attention_bound():
    k = cells.module("kernels", "decode_attn")
    ms, by = peaks.bound_ms("bfloat16", *k.call(16, 8, 256, 128, 2))
    assert (round(ms, 4), by) == (0.0050, "bytes")
    ms, _ = peaks.bound_ms("bfloat16", *k.call(8, 8, 256, 128, 2))
    assert round(ms, 4) == 0.0025


def test_decode_attention_rollout_sums_the_calls():
    k = cells.module("kernels", "decode_attn")
    nbytes, ops, calls = k.rollout(256, 8, 128, 8, 256, 256, 11, 2)
    assert calls == 11 * 8 * 256
    # ~1.09 GB a pixel step at b = 256 (8 layers, mean live rows 128.5)
    assert nbytes / (11 * 256) == pytest.approx(1.09e9, rel=0.01)


def test_fused_layer_bounds():
    k = cells.module("kernels", "fused_layer")
    got = {n: round(peaks.bound_ms("bfloat16", b, f)[0], 4)
           for n, (b, f) in k.counts(64, 256, 512, 8, 128).items()}
    assert got == {7: 0.1042, 8: 0.0434, 9: 0.2432}
    causal = k.counts(64, 256, 512, 8, 128, causal=True)
    assert causal[7][1] < k.counts(64, 256, 512, 8, 128)[7][1]


def test_train_flops_against_the_recorded_mfu():
    # a fused DSFVT b64 step of 0.089-0.104 s was measured at 5.3-6.0% of 989 TFLOP/s
    conf = cells.read_json(f"{cells.HERE}/configs/dsfvt.json")
    flops = cells.module("kernels", "vt_train").flops(conf["vt"], conf["video"], 64)
    assert 0.053 * 989e12 * 0.089 < flops < 0.060 * 989e12 * 0.104


def test_sample_step_is_bound_by_bytes():
    conf = cells.read_json(f"{cells.HERE}/configs/dsfvt.json")
    k = cells.module("kernels", "sample_step")
    nbytes, ops, steps = k.per_step(conf["vt"], conf["video"], 256)
    assert steps == 11 * 256
    assert nbytes / peaks.PEAK_BYTES > ops / peaks.PEAK_FLOPS["bfloat16"]
    assert nbytes == pytest.approx(1.09e9 + 50e6, rel=0.1)  # the cache and the weight stream


def test_vqvae_flops():
    conf = cells.read_json(f"{cells.HERE}/configs/dsfvt.json")
    f = cells.module("kernels", "vqvae").flops(conf["vqvae"], 1, 0)
    assert f == pytest.approx(0.92e9, rel=0.05)  # one 64 x 64 frame encoded
