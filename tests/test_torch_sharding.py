"""The port's LM sharding rules (``repro_torch.distributed.sharding``)
against the reference's: for all ten archs and every runnable cell (32)
on both production meshes, the param, optimizer, batch and cache spec
trees after ``enforce_divisibility``, as ``launch/specs.make_cell`` builds
them, equal the reference's ``make_cell`` specs leaf for leaf (paths,
specs and the argument shapes beside them); OLMoE's experts go over
``model``; on a small mesh ZeRO-1 puts ``data`` on a stack dim in both
packages, and placement then deals whole layers. The meshes are stand-ins
with ``shape`` and ``axis_names``, as ``tests/test_specs.py`` uses."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced_for_smoke as ref_reduced  # noqa: E402
from repro.configs.shapes import SHAPES, all_cells, applicable  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.launch.specs import make_cell as ref_make_cell  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import make_cell  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


class PodMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class MultiPodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


RUNNABLE = [c for c in all_cells() if applicable(ref_get_config(c[0]), SHAPES[c[1]])[0]]


def _ref_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(RS._path_names(p)), x) for p, x in flat]


def _spec(x):
    return tuple(tuple(a) if isinstance(a, tuple) else a for a in x)


def test_runnable_cells_are_32():
    assert len(RUNNABLE) == 32


@pytest.mark.parametrize("mesh", [PodMesh, MultiPodMesh], ids=["pod", "multipod"])
def test_cell_spec_trees_equal_the_reference(mesh):
    for arch, shape in RUNNABLE:
        ref = ref_make_cell(arch, shape, mesh=mesh)
        got = make_cell(arch, shape, mesh=mesh)
        assert got.kind == ref.kind and got.donate == ref.donate
        for r_specs, g_specs, r_args, g_args in zip(ref.in_specs, got.in_specs,
                                                    ref.args, got.args):
            rs, gs = _ref_items(r_specs), S.tree_items(g_specs)
            assert [n for n, _ in rs] == [n for n, _ in gs], (arch, shape)
            assert [_spec(x) for _, x in rs] == [_spec(x) for _, x in gs], (arch, shape)
            assert all(isinstance(x, S.PartitionSpec) for _, x in gs)
            ra = jax.tree_util.tree_leaves(r_args)
            ga = [x for _, x in S.tree_items(g_args)]
            assert [tuple(a.shape) for a in ra] == [tuple(a.shape) for a in ga]
            assert [str(a.dtype) for a in ra] == \
                [str(a.dtype).removeprefix("torch.") for a in ga], (arch, shape)


def test_moe_experts_sharded_over_model():
    """tests/test_specs.py's OLMoE check on the port, against the reference."""
    params = build_model(get_config("olmoe-1b-7b")).param_specs()
    rparams = ref_build_model(ref_get_config("olmoe-1b-7b")).param_specs()
    got = S.tree_items(S.param_pspecs(params, moe=True))
    want = _ref_items(RS.param_pspecs(rparams, moe=True))
    assert [(n, _spec(x)) for n, x in got] == [(n, _spec(x)) for n, x in want]
    experts = [x for n, x in got if "ffn" in n and n[-1] in ("w_gate", "w_up", "w_down")]
    assert len(experts) == 3 and all(x[1] == "model" for x in experts)
    dense = [x for n, x in S.tree_items(S.param_pspecs(params, moe=False))
             if "ffn" in n and n[-1] == "w_down"]
    assert dense == [S.P(None, None, "model", None)]     # the dense rule, trailing


def test_zero1_takes_the_stack_dim_on_a_small_mesh():
    """Three llama smoke layers on a (data 3, model 2) mesh: the stacked
    leaves (3, 64, ...) divide over data only on the stack dim, and ZeRO-1
    puts data there in both packages; placing by those specs deals each
    entry one whole layer (sliced over model where the spec says so)."""
    class Small:
        shape = {"data": 3, "model": 2}
        axis_names = ("data", "model")

    rcfg = ref_reduced(ref_get_config("llama3.2-3b")).scaled(n_layers=3)
    cfg = reduced_for_smoke(get_config("llama3.2-3b")).scaled(n_layers=3, dtype="float32")
    rparams = ref_build_model(rcfg).param_specs()
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")

    def opt_specs(rules, p):
        ps = rules.enforce_divisibility(rules.param_pspecs(p), p, Small)
        return rules.opt_state_pspecs(p, ps, data_axis="data", mesh_axis_size=3)["m"]

    want = _ref_items(opt_specs(RS, rparams))
    got = S.tree_items(opt_specs(S, params))
    assert [(n, _spec(x)) for n, x in got] == [(n, _spec(x)) for n, x in want]
    stacked = [(n, x) for n, x in got if x and x[0] == "data"]
    assert ("final_norm", "scale") not in dict(stacked)
    assert dict(stacked)[("attn_block", "ln1", "scale")] == S.P("data", None)

    mesh = make_mesh((3, 2), ("data", "model"), devices=["cpu"] * 6)
    leaves = dict(S.tree_items(params))
    for names, spec in stacked:
        placed = S.place(leaves[names], S.NamedSharding(mesh, spec))
        whole = torch.stack([t.detach() for t in leaves[names].layers])
        for pos in np.ndindex(3, 2):
            idx = placed.indices[pos]
            assert idx[0] == slice(pos[0], pos[0] + 1)               # one whole layer
            assert torch.equal(placed.shards[pos], whole[idx])
        assert torch.equal(placed.full("cpu"), whole)
        assert len({id(s) for s in placed.shards.flat}) == 6


def test_enforce_divisibility_and_tuple_axes():
    """The reference's rule on hand-made cases: a dim that does not divide
    is replicated, a tuple of axes divides by their product, and the
    shorter spec pads with None."""
    class Mesh_:
        shape = {"pod": 2, "data": 3, "model": 4}
        axis_names = ("pod", "data", "model")

    tree = {"a": torch.empty((6, 8, 5), device="meta"), "b": torch.empty((12,), device="meta"),
            "c": torch.empty((4, 3), device="meta")}
    specs = {"a": S.P("data", "model", "pod"), "b": S.P(("pod", "data")),
             "c": S.P(("pod", "model"))}
    rtree = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in tree.items()}
    rspecs = {k: JP(*v) for k, v in specs.items()}
    got = S.enforce_divisibility(specs, tree, Mesh_)
    want = RS.enforce_divisibility(rspecs, rtree, Mesh_)
    assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
    assert got == {"a": S.P("data", "model", None), "b": S.P(("pod", "data")),
                   "c": S.P(None, None)}
