"""The port's LM distribution against the reference's, on meshes of
repeated CPU entries:

* ``pipeline_forward`` (one controller, GPipe schedule) against the
  reference's ``shard_map`` pipeline on 4 forced host devices (its own
  test's case: 4 stages, 8 micro-batches of 2 x 16), its output taken on
  the host, and against the sequential forward;
* ``remesh`` / ``reshard_tree`` / ``simulate_node_failure`` against the
  reference's ``addressable_shards`` on 8 forced host devices: every mesh
  position's slice and data, replication where an axis stops dividing, a
  stack dim dealt whole and a tuple of axes;
* ``restore_checkpoint(shardings=...)`` both ways: a llama smoke train
  state in bfloat16 written by each package, restored sharded on a
  (data 2, model 2) mesh by both; every entry bit-equal, and the port's
  gather equal to what was written;
* ``launch/train.py``: ``--mesh pod`` / ``multipod`` on a host without 256
  / 512 devices raise naming the count, ``--mesh local`` trains.

The reference runs in two subprocesses started together (as
``tests/test_distributed.py`` runs it), each handing its results back as
an ``.npz``."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.distributed import elastic, sharding as S  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402
from repro_torch.utils.treeutil import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16
CKPT_STEP = 3

_PIPELINE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.distributed.pipeline import pipeline_forward

n_stages, n_micro, mb, d = 4, 8, 2, 16
mesh = jax.make_mesh((4,), ("pipe",))
ws = jax.random.normal(jax.random.PRNGKey(0), (n_stages, d, d)) / np.sqrt(d)
x = jax.random.normal(jax.random.PRNGKey(1), (n_micro, mb, d))

def layer_fn(w, x):
    return jnp.tanh(x @ w)

def staged(ws_local, x):
    return pipeline_forward(layer_fn, ws_local[0], x, n_stages=n_stages, n_micro=n_micro)

fn = shard_map(staged, mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P("pipe"),
               check_rep=False)
with mesh:
    stacked = fn(ws, x)
np.savez(sys.argv[1], ws=np.asarray(ws), x=np.asarray(x),
         got=np.asarray(stacked)[:n_micro])
"""

_ELASTIC = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro.configs import get_config
from repro.configs.base import reduced_for_smoke
from repro.distributed import sharding as RS
from repro.distributed.elastic import remesh, reshard_tree, simulate_node_failure
from repro.models import build_model
from repro.train.step import TrainState, init_train_state

out_npz, port_dir, ref_dir, step = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
arrays, index = {}, {}

def record(case, leaves, mesh):
    index[case] = []
    for i, a in enumerate(leaves):
        by_dev = {s.device.id: s for s in a.addressable_shards}
        rows = []
        for j, dev in enumerate(mesh.devices.flat):
            s = by_dev[dev.id]
            rows.append([list(sl.indices(n)[:2]) for sl, n in zip(s.index, a.shape)])
            arrays[f"{case}/{i}/{j}"] = np.asarray(s.data.astype(jnp.float32))
        index[case].append(rows)

mesh = jax.make_mesh((4, 2), ("data", "model"))
specs = {"w": P("data", "model")}
sharded = reshard_tree({"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}, specs, mesh)
record("initial", [sharded["w"]], mesh)
survivors = simulate_node_failure(mesh, n_lost_nodes=2)
new_mesh = remesh(survivors, model_axis_size=2)
index["new_mesh"] = dict(new_mesh.shape)
index["survivors"] = len(survivors)
record("resharded", [reshard_tree(sharded, specs, new_mesh)["w"]], new_mesh)
stack = jnp.arange(72, dtype=jnp.float32).reshape(3, 4, 6)
record("stack_dim", [reshard_tree({"s": stack}, {"s": P("data", None, "model")},
                                  new_mesh)["s"]], new_mesh)
rows = jnp.arange(48, dtype=jnp.float32).reshape(12, 4)
record("tuple_axes", [reshard_tree({"r": rows}, {"r": P(("data", "model"), None)},
                                   new_mesh)["r"]], new_mesh)

cfg = reduced_for_smoke(get_config("llama3.2-3b")).scaled(dtype="bfloat16")
model = build_model(cfg, max_seq=32, chunk=32)
target = init_train_state(model, jax.random.PRNGKey(0))
ckpt_mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
p_specs = RS.enforce_divisibility(RS.param_pspecs(target.params), target.params, ckpt_mesh)
o_specs = RS.opt_state_pspecs(target.params, p_specs, data_axis="data", mesh_axis_size=2)
o_specs = RS.enforce_divisibility(o_specs, target.opt, ckpt_mesh)
shardings = TrainState(params=RS.named_sharding_tree(ckpt_mesh, p_specs),
                       opt=RS.named_sharding_tree(ckpt_mesh, o_specs),
                       step=NamedSharding(ckpt_mesh, P()), grad_err=None)
restored = restore_checkpoint(port_dir, step, target, shardings)
record("restore_port_written", jax.tree_util.tree_leaves(restored), ckpt_mesh)

ref = init_train_state(model, jax.random.PRNGKey(1))
keys = iter(jax.random.split(jax.random.PRNGKey(2), 1000))
ref.opt["m"] = jax.tree_util.tree_map(lambda p: jax.random.normal(next(keys), p.shape), ref.opt["m"])
ref.opt["v"] = jax.tree_util.tree_map(lambda p: jax.random.uniform(next(keys), p.shape), ref.opt["v"])
ref = TrainState(ref.params, ref.opt, jnp.asarray(step, jnp.int32), None)
save_checkpoint(ref_dir, step, ref)
restored = restore_checkpoint(ref_dir, step, target, shardings)
record("restore_ref_written", jax.tree_util.tree_leaves(restored), ckpt_mesh)
np.savez(out_npz, index=np.array(json.dumps(index)), **arrays)
"""


def _start(code: str, devices: int, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _finish(proc, path):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    return dict(np.load(path))


def _port_state():
    """The llama smoke train state in bfloat16: params from seed 0, ``m``
    normal and ``v`` uniform, step 3."""
    cfg = reduced_for_smoke(get_config(ARCH)).scaled(dtype="bfloat16")
    params = build_model(cfg, max_seq=32, chunk=32).init_params(
        torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    g = torch.Generator().manual_seed(1)
    for m, v in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        m.normal_(generator=g)
        v.uniform_(generator=g)
    return TrainState(params, opt, torch.tensor(CKPT_STEP, dtype=torch.int32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    state = _port_state()
    save_checkpoint(str(tmp / "port"), CKPT_STEP, state)
    pipe = _start(_PIPELINE, 4, tmp / "pipe.npz")
    el = _start(_ELASTIC, 8, tmp / "elastic.npz", tmp / "port", tmp / "ref", CKPT_STEP)
    out = {"pipeline": _finish(pipe, tmp / "pipe.npz")}
    el_out = _finish(el, tmp / "elastic.npz")
    out["index"] = json.loads(str(el_out.pop("index")))
    out["arrays"] = el_out
    out["dirs"] = {"port": str(tmp / "port"), "ref": str(tmp / "ref")}
    out["state"] = state
    return out


def _same_shards(reference, case, leaves):
    """Each leaf's entries against the reference's, position by position:
    the same slice and the same bits."""
    want = reference["index"][case]
    assert len(leaves) == len(want), case
    for i, (leaf, rows) in enumerate(zip(leaves, want)):
        assert isinstance(leaf, S.Sharded)
        for j, (idx, shard) in enumerate(zip(leaf.indices.flat, leaf.shards.flat)):
            assert [[s.start, s.stop] for s in idx] == rows[j], (case, i, j)
            got = shard.float().numpy()
            assert np.array_equal(got, reference["arrays"][f"{case}/{i}/{j}"]), (case, i, j)


def test_pipeline_equals_the_reference_and_the_sequential_forward(reference):
    r = reference["pipeline"]
    ws, x = torch.from_numpy(r["ws"]), torch.from_numpy(r["x"])

    def layer_fn(w, h):
        return torch.tanh(h @ w)

    got = pipeline_forward(layer_fn, list(ws), x, n_stages=N_STAGES, n_micro=N_MICRO,
                           devices=["cpu"] * N_STAGES)
    seq = x
    for s in range(N_STAGES):
        seq = torch.tanh(seq @ ws[s])
    assert got.shape == (N_MICRO, MB, D)
    np.testing.assert_allclose(got.numpy(), r["got"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r["got"], seq.numpy(), rtol=0, atol=1e-5)


def test_pipeline_schedule_counts_each_stage_n_micro_times():
    calls = []

    def layer_fn(s, h):
        calls.append(s)
        return h + 1

    x = torch.zeros((5, 1, 1))
    out = pipeline_forward(layer_fn, [0, 1, 2], x, n_stages=3, n_micro=5,
                           devices=["cpu"] * 3)
    assert out.flatten().tolist() == [3.0] * 5
    assert sorted(calls) == [0] * 5 + [1] * 5 + [2] * 5
    with pytest.raises(ValueError, match="3 stages"):
        pipeline_forward(layer_fn, [0, 1], x, n_stages=3, n_micro=5, devices=["cpu"] * 3)


def test_elastic_remesh_and_reshard_equal_the_reference(reference):
    P = S.P
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    specs = {"w": P("data", "model")}
    sharded = elastic.reshard_tree({"w": x}, specs, mesh)
    _same_shards(reference, "initial", [sharded["w"]])

    survivors = elastic.simulate_node_failure(mesh, n_lost_nodes=2)
    new_mesh = elastic.remesh(survivors, model_axis_size=2)
    assert len(survivors) == reference["index"]["survivors"] == 6
    assert new_mesh.shape == reference["index"]["new_mesh"] == {"data": 3, "model": 2}
    resharded = elastic.reshard_tree(sharded, specs, new_mesh)
    _same_shards(reference, "resharded", [resharded["w"]])
    assert resharded["w"].spec == P(None, "model")        # 8 rows do not divide by 3
    assert torch.equal(resharded["w"].full("cpu"), x)

    stack = torch.arange(72, dtype=torch.float32).reshape(3, 4, 6)
    placed = elastic.reshard_tree({"s": S.Stacked(list(stack))},
                                  {"s": P("data", None, "model")}, new_mesh)
    _same_shards(reference, "stack_dim", [placed["s"]])
    rows = torch.arange(48, dtype=torch.float32).reshape(12, 4)
    placed = elastic.reshard_tree({"r": rows}, {"r": P(("data", "model"), None)}, new_mesh)
    _same_shards(reference, "tuple_axes", [placed["r"]])
    with pytest.raises(ValueError, match="cannot keep TP=4"):
        elastic.remesh(survivors[:3], model_axis_size=4)


def _port_shardings(state, mesh):
    p_specs = S.enforce_divisibility(S.param_pspecs(state.params), state.params, mesh)
    o_specs = S.opt_state_pspecs(state.params, p_specs, data_axis="data", mesh_axis_size=2)
    o_specs = S.enforce_divisibility(o_specs, state.opt, mesh)
    return TrainState(params=S.named_sharding_tree(mesh, p_specs),
                      opt=S.named_sharding_tree(mesh, o_specs),
                      step=S.NamedSharding(mesh, S.P()), grad_err=None)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_sharded_restore_is_bit_equal_both_ways(reference, writer):
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    target = _port_state()
    shardings = _port_shardings(target, mesh)
    before = [t.clone() for t in tree_leaves(target.params)]
    got = restore_checkpoint(reference["dirs"][writer], CKPT_STEP, target, shardings)
    assert isinstance(got, TrainState) and isinstance(got.params, dict)
    leaves = [x for _, x in S.tree_items(got)]
    _same_shards(reference, f"restore_{writer}_written", leaves)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(target.params)))
    if writer == "port":                   # the gather is what was written
        src = [x for _, x in S.tree_items(reference["state"])]
        for placed, want in zip(leaves, src):
            whole = want[:] if isinstance(want, S.Stacked) else want
            assert placed.dtype == whole.dtype and torch.equal(placed.full("cpu"), whole)
    specs = [x.spec for x in leaves]
    assert any("data" in s for s in specs) and any("model" in s for s in specs)


def test_train_launcher_meshes(tmp_path, capsys):
    base = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(ValueError, match="needs exactly 256 devices, found 1"):
        launch.main(base + ["--mesh", "pod"])
    with pytest.raises(ValueError, match="needs exactly 512 devices, found 1"):
        launch.main(base + ["--mesh", "multipod"])
    assert not (tmp_path / "ck").exists()
    stats = launch.main(base + ["--mesh", "local"])
    assert stats["final_step"] == 2
    assert "[train] mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
