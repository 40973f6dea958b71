"""Checkpoints: the port's counterparts of ``tests/test_checkpoint.py``'s
five tests (round trip, an uncommitted step ignored, corruption caught,
the async writer, a shape mismatch refused), then the two packages
against each other on LM training states: the same state written by both
gives equal manifests (names, order, files, shapes, dtypes, stored dtypes
and ``sha``s) and equal bytes, in float32 and bfloat16, with and without
the compression residual; the port restores what the reference wrote after
two of its train steps and the reference restores what the port wrote,
bit for bit."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_lm import (one_torch_thread, ref_state_from_numpy,  # noqa: E402,F401
                       ref_state_to_numpy, ref_train_state)
from repro.checkpoint import ckpt as RK  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced_for_smoke as ref_reduced  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,  # noqa: E402
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.convert import train_state_from_reference, train_state_to_reference  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.utils.treeutil import tree_leaves  # noqa: E402

ARCH = "llama3.2-3b"


def _tree(seed=0):
    """tests/test_checkpoint.py's tree: float32, int32, bfloat16 and a
    float32 scalar."""
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn((4,), generator=g).to(torch.bfloat16)},
            "scalar": torch.tensor(3.5, dtype=torch.float32)}


def _zeros_like(t):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in t.items()}


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    target = _zeros_like(t)
    got = restore_checkpoint(str(tmp_path), 7, target)
    assert got is target and _equal(got, t)        # in place, bit for bit


def test_uncommitted_checkpoint_ignored(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    path = save_checkpoint(str(tmp_path), 10, t)
    os.remove(os.path.join(path, "COMMIT"))      # a crash mid-write
    assert latest_step(str(tmp_path)) == 5


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    victim = os.path.join(path, "leaf_00000.npy")
    data = bytearray(open(victim, "rb").read())
    data[-1] ^= 0xFF
    open(victim, "wb").write(bytes(data))
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), 1, t)


def test_async_checkpointer(tmp_path):
    t = _tree()
    before = t["a"].clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, t)
    t["a"].add_(1.0)            # the host copy was taken at save()
    ck.close()
    assert latest_step(str(tmp_path)) == 3
    got = restore_checkpoint(str(tmp_path), 3, _zeros_like(t))
    assert torch.equal(got["a"], before)


def test_restore_shape_mismatch_raises(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 2, t)
    bad = dict(t)
    bad["a"] = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 2, bad)
    assert torch.equal(t["a"], _tree()["a"])     # nothing written before the check
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 2, bad, shardings=_shardings(bad))
    with pytest.raises(ValueError, match="1 shardings for 4 leaves"):
        restore_checkpoint(str(tmp_path), 2, t, shardings={"a": _shardings(t)["a"]})


def _shardings(tree):
    """Every leaf replicated on a one-entry CPU mesh."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import P, NamedSharding
    mesh = make_mesh((1,), ("data",), devices=["cpu"])
    return {k: _shardings(v) if isinstance(v, dict) else NamedSharding(mesh, P())
            for k, v in tree.items()}


def _cfgs(dtype):
    return (ref_reduced(ref_get_config(ARCH)).scaled(dtype=dtype),
            reduced_for_smoke(get_config(ARCH)).scaled(dtype=dtype))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_packages_write_the_same_checkpoint(tmp_path, dtype, compression):
    """One reference init carried into the port: both packages' manifests
    and leaf files are equal, byte for byte."""
    ref_cfg, cfg = _cfgs(dtype)
    init = ref_train_state(ref_cfg, seed=3, use_compression=compression, max_seq=16)
    rpath = RK.save_checkpoint(str(tmp_path / "ref"), 4, ref_state_from_numpy(init))
    ppath = save_checkpoint(str(tmp_path / "port"), 4,
                            train_state_from_reference(init, cfg, "cpu"))
    rm, pm = _manifest(rpath), _manifest(ppath)
    assert pm == rm
    assert len(rm["leaves"]) == (46 if compression else 35)
    assert rm["leaves"][0]["name"] == "[<flat index 0>]['attn_block']['attn']['wk']"
    if dtype == "bfloat16":
        assert {x["stored_dtype"] for x in pm["leaves"] if x["dtype"] == "bfloat16"} == {"uint16"}
    for leaf in rm["leaves"]:
        assert open(os.path.join(rpath, leaf["file"]), "rb").read() == \
            open(os.path.join(ppath, leaf["file"]), "rb").read()


def test_checkpoints_cross_between_packages(tmp_path):
    """The reference trains two steps and saves; the port restores it into
    a state of its own init, equal to the reference's bit for bit. Then the
    port trains two steps and saves; the reference restores it, equal to
    the port's bit for bit."""
    ref_cfg, cfg = _cfgs("bfloat16")
    kw = dict(max_seq=16, chunk=8)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
             "mask": np.ones((2, 16), np.float32)}

    init = ref_train_state(ref_cfg, seed=1, **kw)
    ref_step = jax.jit(ref_make_step(ref_build_model(ref_cfg, **kw), RefAdamW(lr=1e-2),
                                     warmup=1, total_steps=10))
    rst = ref_state_from_numpy(init)
    for _ in range(2):
        rst, _ = ref_step(rst, {k: jnp.asarray(v) for k, v in batch.items()})
    RK.save_checkpoint(str(tmp_path / "ref"), 2, rst)
    model = build_model(cfg, **kw)
    target = init_train_state(model, torch.Generator().manual_seed(9), device="cpu")
    restored = restore_checkpoint(str(tmp_path / "ref"), 2, target)
    assert restored is target
    want, got = ref_state_to_numpy(rst), train_state_to_reference(restored)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        assert np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32)), path
    assert restored.params.embed.dtype == torch.bfloat16

    step = make_train_step(model, AdamWConfig(lr=1e-2), warmup=1, total_steps=10)
    for _ in range(2):
        restored, _ = step(restored, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(restored.step) == 4
    save_checkpoint(str(tmp_path / "port"), 4, restored)
    back = RK.restore_checkpoint(str(tmp_path / "port"), 4, ref_state_from_numpy(init))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(
            train_state_to_reference(restored)),
            jax.tree_util.tree_leaves_with_path(ref_state_to_numpy(back))):
        assert np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32)), path
