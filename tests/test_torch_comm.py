"""The port's cross-process layer held to lvt_tpu on the CPU:

* utils/comm.py in a world of one and in a world of 2 gloo processes
  (spawned once for the module through engine.launch): rank and sizes,
  all_gather of ragged dicts, gather, a shared_random_seed that is rank 0's
  draw on both ranks (the ranks' own draws differ), reduce_dict, a barrier;
* parallel/collectives.py's all_gather, reduce_scatter and all_reduce, and
  their gradients, against lvt_tpu/parallel/collectives.py under shard_map
  on a 2-device data mesh (tests/test_parallel.py drives them so), on the
  same numpy inputs: fp32, sums of 2 terms in either order (1e-6);
* apply_norm(..., group=) against lvt_tpu's apply_norm(..., axis_name=)
  under shard_map for BN (per rank), SyncBN and nnSyncBN (synced): output,
  running statistics, input gradient and the parameters' gradient summed
  over the ranks (fp32, 1e-5);
* launch: a rank that raises makes launch raise; a rank that hangs is killed
  at the join timeout, which raises; the training CLI's run() spawns its
  world and rank 0 verifies the results of --eval-only there.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lvt_tpu.models.norms import apply_norm as jax_apply_norm
from lvt_tpu.parallel import collectives as jcoll
from lvt_tpu_torch.engine.launch import launch
from lvt_tpu_torch.parallel import mesh as tmesh
from lvt_tpu_torch.utils import comm
from torch_dp_worker import (comm_scenarios, failing_rank, hanging_rank, one_thread_children,
                             spawn_world)

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _payload():
    rng = np.random.default_rng(7)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "all_gather": {"x": f32(WORLD, 4, 3), "w": f32(WORLD, WORLD * 4, 3)},
        "reduce_scatter": {"x": f32(WORLD, 4, 3), "w": f32(WORLD, 4 // WORLD, 3)},
        "all_reduce": {"x": f32(WORLD, 4, 3), "w": f32(WORLD, 4, 3)},
        "norm": {"x": 1.5 * f32(WORLD, 4, 4, 4, 6) + 0.5, "w": f32(WORLD, 4, 4, 4, 6),
                 "params": {"scale": 1 + 0.1 * f32(6), "bias": 0.1 * f32(6)},
                 "state": {"mean": 0.1 * f32(6), "var": 1 + 0.1 * np.abs(f32(6))}},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    payload = _payload()
    return payload, spawn_world(comm_scenarios, payload, str(tmp_path_factory.mktemp("comm")))


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _joined(a):
    """(WORLD, n, ...) per-rank parts -> the global (WORLD * n, ...) array."""
    return jnp.asarray(a.reshape((-1,) + a.shape[2:]))


# --------------------------------------------------------------------------
# utils/comm.py
# --------------------------------------------------------------------------

def test_comm_world_of_one():
    data = {"mse": 1.5, "feats": [np.arange(3)]}
    assert (comm.get_world_size(), comm.get_rank(), comm.get_local_rank(),
            comm.get_local_size(), comm.is_main_process()) == (1, 0, 0, 1, True)
    assert comm.synchronize() is None
    assert comm.all_gather(data)[0] is data and comm.gather(data)[0] is data
    reduced = {"a": 2.0}
    assert comm.reduce_dict(reduced) is reduced
    assert isinstance(comm.shared_random_seed(), int)


def test_comm_ranks_and_sizes(world):
    _, res = world
    assert [r["world"] for r in res] == [(2, 0, 0, 2, True), (2, 1, 1, 2, False)]


def test_comm_all_gather_ragged_and_gather(world):
    _, res = world
    for r in res:
        got = r["all_gather"]
        assert [g["rank"] for g in got] == [0, 1]
        assert [g["items"] for g in got] == [[0], [0, 1, 2, 3]]
        for i, g in enumerate(got):
            np.testing.assert_array_equal(g["arr"], np.arange(i + 2))
    assert res[0]["gather"] == [[0, 0], [1, 1, 1]] and res[1]["gather"] == []


def test_shared_random_seed_is_rank_0s_draw(world):
    """Fails where each rank returns its own draw."""
    _, res = world
    assert res[0]["own_draw"] != res[1]["own_draw"]
    assert res[0]["shared_seed"] == res[1]["shared_seed"] == res[0]["own_draw"]


def test_reduce_dict_on_every_rank(world):
    _, res = world
    for r in res:
        assert sorted(r["reduce_mean"]) == ["a", "b"]
        assert float(r["reduce_mean"]["a"]) == 1.5 and r["reduce_mean"]["b"] == 1.0
        assert float(r["reduce_sum"]["a"]) == 3.0


# --------------------------------------------------------------------------
# The collectives and apply_norm(group=) against lvt_tpu under shard_map
# --------------------------------------------------------------------------

def _jax_collective(name, x, w):
    mesh = _mesh()
    fn = {"all_gather": lambda v: jcoll.all_gather(v, "data"),
          "reduce_scatter": lambda v: jcoll.reduce_scatter(v, "data"),
          "all_reduce": lambda v: jcoll.all_reduce(v, "data")}[name]
    ys = jax.jit(shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=P("data")))(x)

    def total(xs):
        per = shard_map(lambda v, u: jnp.sum(fn(v) * u)[None], mesh=mesh,
                        in_specs=(P("data"), P("data")), out_specs=P("data"))(xs, w)
        return per.sum()

    return np.asarray(ys), np.asarray(jax.jit(jax.grad(total))(x))


@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter", "all_reduce"])
def test_collective_and_its_gradient_match_shard_map(world, name):
    payload, res = world
    p = payload[name]
    ys, gx = _jax_collective(name, _joined(p["x"]), _joined(p["w"]))
    n_out, n_in = ys.shape[0] // WORLD, p["x"].shape[1]
    for r in range(WORLD):
        y, dx = res[r][name + "_fn"]
        np.testing.assert_allclose(y, ys[r * n_out:(r + 1) * n_out], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, gx[r * n_in:(r + 1) * n_in], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm", ["BN", "SyncBN", "nnSyncBN"])
def test_apply_norm_group_matches_axis_name(world, norm):
    payload, res = world
    p = payload["norm"]
    params = {k: jnp.asarray(v) for k, v in p["params"].items()}
    state = {k: jnp.asarray(v) for k, v in p["state"].items()}
    mesh = _mesh()

    def per_rank(x, w, prm):
        y, ns = jax_apply_norm(norm, prm, state, x, train=True, axis_name="data")
        return y, {k: v[None] for k, v in ns.items()}, jnp.sum(y * w)[None]

    run = shard_map(per_rank, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                    out_specs=(P("data"), P("data"), P("data")))
    x, w = _joined(p["x"]), _joined(p["w"])
    y, ns, _ = jax.jit(run)(x, w, params)
    dx, dparams = jax.jit(jax.grad(lambda a, b: run(a, w, b)[2].sum(), argnums=(0, 1)))(
        x, params)
    n = p["x"].shape[1]
    for r in range(WORLD):
        got = res[r][norm]
        np.testing.assert_allclose(got["y"], np.asarray(y)[r * n:(r + 1) * n], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dx"], np.asarray(dx)[r * n:(r + 1) * n], rtol=1e-5,
                                   atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got["state"][k], np.asarray(ns[k])[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} running {k}")
    for k in ("scale", "bias"):
        summed = sum(res[r][norm]["dparams"][k] for r in range(WORLD))
        np.testing.assert_allclose(summed, np.asarray(dparams[k]), rtol=1e-5, atol=1e-5)
    if norm == "BN":  # per rank: the two ranks' statistics differ
        assert not np.allclose(res[0][norm]["state"]["mean"], res[1][norm]["state"]["mean"])


# --------------------------------------------------------------------------
# launch, and the mesh's refusals
# --------------------------------------------------------------------------

def test_a_failing_rank_makes_launch_raise(tmp_path):
    with pytest.raises(Exception, match="fails on purpose"):
        spawn_world(failing_rank, None, str(tmp_path), join_timeout=120)


def test_a_hanging_rank_is_killed_at_the_join_timeout():
    with pytest.raises(TimeoutError), one_thread_children():
        launch(hanging_rank, WORLD, backend="gloo", args=(None,), join_timeout=8)


def test_mesh_refuses_what_is_not_ported():
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    assert tmesh.data_group(cfg) is None
    cfg.TPU.MESH_DATA = 2
    with pytest.raises(ValueError, match="MESH_DATA"):
        tmesh.data_group(cfg)
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = -1, 2  # a model axis of 2 in a world of 1
    with pytest.raises(ValueError, match="MESH_MODEL 2 does not divide the world of 1"):
        tmesh.data_group(cfg)
    cfg.TPU.MESH_MODEL, cfg.TPU.SHARD_SPATIAL = 1, True  # accepted (tests/test_torch_sp.py)
    assert tmesh.data_group(cfg) is None and tmesh.model_group(cfg) is None
    with pytest.raises(ValueError, match="backend"):
        launch(print, 2, backend="mpi")


def test_the_cli_launches_its_world_and_verifies_on_rank_0(tmp_path, monkeypatch):
    """tools/train_net_torch.py's run(): --num-gpus 2 --dist-backend gloo
    spawns the world itself (engine.launch), whose processes read test
    latents at their builtin.py path (prdvqvae_test, under the working
    directory). --eval-only of a tiny VT from its seed meets
    TEST.EXPECTED_RESULTS set to the bits/dim of the same evaluation in this
    process, within 1e-9 (rank 0 exits with 1 on a miss, and run() raises)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from test_torch_data_parallel import _cli_payload

    rng = np.random.default_rng(3)
    root = tmp_path / "datasets" / "prdvqvae2" / "inference" / "bair_test_seq"
    for v in range(3):
        (root / f"video_{v}").mkdir(parents=True)
        for f in range(8):
            np.save(root / f"video_{v}" / f"{f}.npy", rng.integers(0, 512, (4, 8, 8)))
    monkeypatch.chdir(tmp_path)
    argv = _cli_payload(str(tmp_path))["argv"]["vt"] + ["DATASETS.TEST", "('prdvqvae_test',)"]
    parse = default_argument_parser().parse_args
    one = train_net_torch.main(parse(["--eval-only"] + argv), device="cpu")
    bits = float(one["likelihood"]["bits_per_dim"])
    assert np.isfinite(bits)
    args = parse(["--num-gpus", "2", "--dist-backend", "gloo", "--eval-only"] + argv +
                 ["TEST.EXPECTED_RESULTS", f"[['likelihood', 'bits_per_dim', {bits!r}, 1e-9]]"])
    with one_thread_children():
        assert train_net_torch.run(args, device="cpu") is None
