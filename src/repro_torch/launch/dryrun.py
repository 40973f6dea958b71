"""Multi-pod dry run: every (arch x shape x mesh) cell laid out on the
production meshes, restated for PyTorch.

Counterpart of ``repro.launch.dryrun``. The reference forces 512 host
devices, lowers and compiles every cell's step under its in_shardings and
reads XLA's memory and cost analyses and the collectives of the
partitioned HLO. PyTorch has no such compile of a sharded program, so the
port restates what it can without one:

  * the cell's inputs are ``meta`` tensors (``launch/specs.py``), laid out
    on the production mesh of 256 or 512 ``meta`` entries;
  * ``arg_bytes_per_device``: the bytes each device holds under the
    sharding rules after ``enforce_divisibility`` (the reference's
    ``_sharded_arg_bytes``, equal to its numbers), and ``fits``: that
    against the card's memory;
  * ``per_chip`` FLOPs and bytes: the analytic work of the whole step
    (``utils/roofline.lm_train_roofline`` / ``lm_step_roofline``, every
    family as the port formulates it) over the chips, and ``roofline``
    from them at the H100's peaks, ``model_flops`` by the reference's
    formulas;
  * ``collectives`` (operand bytes a chip by kind, the reference's
    convention: the bytes each collective of the per-device program takes
    in), ``per_chip.coll_bytes`` (their sum) and ``roofline.t_collective_s``
    reckoned from the sharding rules the cell is laid out with, by the
    model below.

Written as null, with no PyTorch counterpart: ``memory_analysis`` (XLA's
argument / output / temp / peak bytes of the compiled program),
``cost_analysis_raw`` (XLA's own cost analysis), ``lower_s`` and
``compile_s``: no XLA compile exists. ``--unroll`` is accepted and
recorded; the analytic count is whole-step either way. No environment
variable is set.

The collective model. Layout: the batch shards over the data axes (pod and
data) where it divides; weights, optimizer state and caches by
``sharding.param_pspecs`` (with ``_MOE_EXPERT_RULES``),
``opt_state_pspecs`` (ZeRO-1 over data), ``batch_pspecs`` and
``cache_pspecs``, after ``enforce_divisibility``: a dim that does not
divide is replicated (Llama-3.2-3B's 8 KV heads, Whisper's 8 heads and
51,865-row vocabulary). A block's input and output are replicated over the
model axis. Within a forward, on the chip's T = local batch x new tokens
rows, in bf16 activations (``cfg.dtype``):

  * a row-parallel product (its weight's contracted dim sharded over
    model: ``wo``, ``w_down``, ``w_out``, the rec block's ``w_out``,
    ``ffn_down``) ends in an all-reduce of its (T, out) output over model;
    a column-parallel product (output dim sharded) leaves its output
    sharded, and elementwise work keeps that layout;
  * a product whose contracted dim is not sharded but whose input arrives
    sharded is preceded by an all-gather of that input over model (operand:
    the chip's (T, in / model) shard): the RG-LRU gates ``w_a`` / ``w_x``
    after the sharded conv, the mLSTM's ``w_q`` / ``w_k`` / ``w_v`` after
    its sharded up-projection and conv;
  * attention runs on whole heads: heads shard with ``wq`` where they
    divide, and the mLSTM's 4 heads, whose features shard 16 ways, are
    all-gathered (q, k, v) first; the sLSTM's replicated block-diagonal
    recurrence reads the whole h, so each time step all-gathers the
    chip's (local batch, D / model) float32 h;
  * a MoE layer whose experts shard over model (``_MOE_EXPERT_RULES``)
    exchanges its capacity buffers twice, a dispatch and a combine
    all-to-all, each of operand E x C x D / model bytes (C from the chip's
    T, as ``moe.capacity`` computes it);
  * the embedding, vocab-sharded where V divides, all-reduces its (T, D)
    lookup over model; the head is column-parallel on the vocabulary, so
    serving leaves the logits sharded, and training all-reduces the loss's
    per-row max, sum and gold logit (3 x T float32);
  * a decode step over a cache whose sequence dim shards over model
    (``cache_pspecs`` where the KV heads do not divide, always for the MLA
    latent, and Whisper's self and cross K/V) attends split-K: q is
    all-gathered first where its heads shard, head-sharded weights that
    multiply cache rows (MLA's ``w_uk`` / ``w_uv``) are all-gathered (their
    chip's shard), and each attention all-reduces its partial output with
    its max and sum ((B, H, hd_v + 2) float32).

Training (``make_train_step``): the backward pass moves what the forward
moved, each forward all-reduce matched by one all-reduce of the same bytes
(Megatron's conjugate pair: a column-parallel group's input gradient), each
all-gather by a reduce-scatter of the gathered bytes and each all-to-all by
an all-to-all; the head's input gradient adds one (T, D) all-reduce and the
embedding none. Remat recomputes the blocks' forward, collectives and all.
Microbatching splits T into ``--microbatches`` parts that move the same
bytes in all; the gradients are accumulated first and reduced once a step:
a leaf whose ZeRO-1 ``m`` / ``v`` shard over data reduce-scatters its
gradient over data (operand: the chip's model shard of the gradient, in the
leaf's dtype), all-reduces the scattered part over pod on the multi-pod
mesh, and all-gathers the updated parameter over data after AdamW
(operand: its data shard); a leaf with no data-sharded dim all-reduces its
gradient over the data axes. Not reckoned: XLA's own resharding (the
reference's HLO shows ``collective-permute`` no rule asks for), the
global-norm scalar, float32 upcasts of collectives, and collectives of the
kinds above that XLA fuses or splits otherwise.

Nodes: 8 GPUs a node, mesh entries numbered row-major over
``mesh.axis_names`` and dealt to nodes in runs of 8. So on 16 x 16
(data, model) and 2 x 16 x 16 (pod, data, model) a model group is 16
consecutive GPUs over two nodes, and data and pod groups are a GPU per node
over 16 and 32 nodes: every axis crosses nodes. A collective over an axis
whose group stays within a node is timed at ``NVLINK_BYTES_PER_S``, one
that crosses nodes at ``IB_BYTES_PER_S`` (the slowest link of the ring),
on the bytes a ring moves a chip: 2 (n - 1) / n x the operand for an
all-reduce, (n - 1) x for an all-gather, (n - 1) / n for a reduce-scatter
or an all-to-all, over a group of n. ``roofline.t_collective_s`` is their
sum, ``roofline.coll_bytes`` the operand bytes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.distributed.sharding import tree_items
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_cell
from repro_torch.models.transformer import block_layout
from repro_torch.utils import roofline as rl

# NVIDIA H100 SXM5 datasheet: 80 GB of HBM3, read when no card is present
H100_MEMORY_BYTES = 80e9
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
MODEL = ("model",)


def _sharded_arg_bytes(args, in_specs, mesh) -> float:
    """Per-device bytes of the step inputs under their shardings."""
    total = 0.0
    for a_tree, s_tree in zip(args, in_specs):
        flat_a = [a for _, a in tree_items(a_tree)]
        flat_s = [s for _, s in tree_items(s_tree)]
        if len(flat_a) != len(flat_s):
            raise ValueError(f"{len(flat_a)} args, {len(flat_s)} specs")
        for a, s in zip(flat_a, flat_s):
            n = float(np.prod(a.shape)) * a.element_size()
            denom = 1
            for axis in (s or ()):
                if axis is None:
                    continue
                for ax in (axis if isinstance(axis, tuple) else (axis,)):
                    denom *= mesh.shape[ax]
            total += n / denom
    return total


def device_memory() -> tuple[float, str]:
    """The card's memory in bytes and where the number comes from."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                "torch.cuda.get_device_properties")
    return H100_MEMORY_BYTES, "NVIDIA H100 SXM5 datasheet (80 GB)"


def _work(cfg, cell, shape):
    """The whole step's analytic FLOPs and bytes (``utils/roofline``)."""
    if cell.kind == "train":
        return rl.lm_train_roofline(cfg, shape.global_batch, shape.seq_len,
                                    remat=cell.model.remat, chunk=cell.model.chunk)
    new = shape.seq_len if cell.kind == "prefill" else 1
    return rl.lm_step_roofline(cfg, shape.global_batch, new, shape.seq_len,
                               enc_seq=shape.seq_len, chunk=cell.model.chunk)


# ---------------------------------------------------------------------------
# collectives (the model in the module docstring)
# ---------------------------------------------------------------------------


def _axes_of(part) -> tuple:
    return () if part is None else (part if isinstance(part, tuple) else (part,))


def _table(args, specs) -> dict:
    """``"a/b/c"`` -> (spec parts padded to the leaf's rank, shape)."""
    out = {}
    for (names, leaf), (_, spec) in zip(tree_items(args), tree_items(specs)):
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        out["/".join(names)] = (parts, tuple(leaf.shape))
    return out


def _split(parts, *offsets) -> bool:
    return any("model" in _axes_of(parts[o]) for o in offsets)


class _ModelAxis:
    """The model axis's collectives of one layer's forward, as ``(kind,
    operand bytes)``; ``layout`` says which activations are sharded."""

    def __init__(self, cfg, params: dict, model_size: int, bpe: int):
        self.cfg, self.params, self.M, self.bpe = cfg, params, model_size, bpe
        self.ops: list[tuple[str, float]] = []
        self.layout: dict[str, bool] = {}

    def mm(self, w, x, y, rows, contracted=(-2,)):
        """``y = x @ w`` on ``rows`` rows; ``contracted``: the weight's
        trailing dims that ``x`` supplies, the ones after them are ``y``'s."""
        parts, shape = self.params[w]
        d_in = math.prod(shape[o] for o in contracted)
        out = shape[max(contracted) + 1:]
        if _split(parts, *contracted):                     # row-parallel
            self.ops.append(("all-reduce", rows * math.prod(out) * self.bpe))
            self.layout[y] = False
            return
        if self.layout.get(x, False):
            self.ops.append(("all-gather", rows * d_in * self.bpe / self.M))
            self.layout[x] = False
        self.layout[y] = _split(parts, *range(max(contracted) + 1, 0))

    def ew(self, y, *xs):
        self.layout[y] = any(self.layout.get(x, False) for x in xs)

    def _splitk(self, cache, seq_offset) -> bool:
        return cache is not None and _split(cache[0], seq_offset)

    def attn(self, pre, rows, batch, cache=None):
        parts, (*_, H, hd) = self.params[f"{pre}/wq"]
        q_split = _split(parts, -2)
        if self._splitk(cache, -3):                       # K: (L, B, S, KV, hd)
            if q_split:
                self.ops.append(("all-gather", rows * H * hd * self.bpe / self.M))
            self.ops.append(("all-reduce", batch * H * (hd + 2) * 4))
            q_split = False
        self.layout["o"] = q_split
        self.mm(f"{pre}/wo", "o", "y", rows, contracted=(-3, -2))

    def mla(self, pre, rows, batch, cache=None):
        parts, (*_, H, qk) = self.params[f"{pre}/wq"]
        q_split = _split(parts, -2)
        if self._splitk(cache, -2):                       # latent: (L, B, S, r + rope)
            if q_split:
                self.ops.append(("all-gather", rows * H * qk * self.bpe / self.M))
            for w in ("w_uk", "w_uv"):
                wp, ws = self.params[f"{pre}/{w}"]
                if _split(wp, -2):
                    self.ops.append(("all-gather", math.prod(ws[-3:]) * self.bpe / self.M))
            v = self.params[f"{pre}/w_uv"][1][-1]
            self.ops.append(("all-reduce", batch * H * (v + 2) * 4))
            q_split = False
        self.layout["o"] = q_split
        self.mm(f"{pre}/wo", "o", "y", rows, contracted=(-3, -2))

    def ffn(self, pre, rows):
        cfg = self.cfg
        if cfg.moe is not None:
            m = cfg.moe
            if _split(self.params[f"{pre}/w_gate"][0], -3):   # experts over model
                slots = m.n_experts * max(int(np.ceil(rows * m.top_k / m.n_experts
                                                      * m.capacity_factor)), 1)
                self.ops += [("all-to-all", slots * cfg.d_model * self.bpe / self.M)] * 2
            if m.n_shared:
                self._swiglu(f"{pre}/shared", rows)
        elif cfg.ffn == "swiglu":
            self._swiglu(pre, rows)
        else:
            self.mm(f"{pre}/w_in", "h2", "a", rows)
            self.mm(f"{pre}/w_out", "a", "y", rows)

    def _swiglu(self, pre, rows):
        self.mm(f"{pre}/w_gate", "h2", "g", rows)
        self.mm(f"{pre}/w_up", "h2", "u", rows)
        self.ew("a", "g", "u")
        self.mm(f"{pre}/w_down", "a", "y", rows)

    def rec(self, pre, rows):
        self.mm(f"{pre}/w_in_main", "h", "main", rows)
        self.mm(f"{pre}/w_in_gate", "h", "gate", rows)
        self.ew("cx", "main")                              # the conv, sharded alike
        self.mm(f"{pre}/w_a", "cx", "r", rows)
        self.mm(f"{pre}/w_x", "cx", "i", rows)
        self.ew("out", "r", "i", "cx", "gate")
        self.mm(f"{pre}/w_out", "out", "y", rows)

    def mlstm(self, pre, rows):
        self.mm(f"{pre}/w_up", "h", "up", rows)
        self.ew("x_in", "up")
        self.ew("z", "up")
        self.ew("cx", "x_in")                              # the conv, sharded alike
        for w, x, y in (("w_q", "cx", "q"), ("w_k", "cx", "k"), ("w_v", "x_in", "v"),
                        ("w_i", "cx", "ig"), ("w_f", "cx", "fg")):
            self.mm(f"{pre}/{w}", x, y, rows)
        if self.cfg.n_heads % self.M:                      # the heads' features split
            d_in = self.params[f"{pre}/w_q"][1][-1]
            for t in ("q", "k", "v"):
                if self.layout[t]:
                    self.ops.append(("all-gather", rows * d_in * self.bpe / self.M))
                    self.layout[t] = False
        self.ew("out", "q", "k", "v", "z")
        self.mm(f"{pre}/w_down", "out", "y", rows)

    def slstm(self, pre, rows, batch, steps):
        self.mm(f"{pre}/w_zifo", "h", "xp", rows)
        if self.layout["xp"]:                              # h is sharded like xp
            self.ops += [("all-gather", batch * self.cfg.d_model * 4 / self.M)] * steps
        self.mm(f"{pre}/ffn_up", "hs", "u", rows)
        self.ew("a", "u")
        self.mm(f"{pre}/ffn_down", "a", "y", rows)

    def block(self, btype, rows, batch, steps, caches):
        """One layer of type ``btype``; ``caches``: the decode step's cache
        table, else None. Returns its ops."""
        self.ops, self.layout = [], {}
        kv = (caches or {}).get
        if btype in ("attn_block", "attn"):
            self.attn(f"{btype}/attn", rows, batch, kv(f"{btype}/k"))
        elif btype == "mla_block":
            self.mla(f"{btype}/attn", rows, batch, kv(f"{btype}/ckv"))
        elif btype == "rec":
            self.rec("rec/rec", rows)
        elif btype == "mlstm":
            self.mlstm("mlstm/cell", rows)
        elif btype == "slstm":
            self.slstm("slstm/cell", rows, batch, steps)
        elif btype == "enc":
            self.attn("enc_blocks/attn", rows, batch)
            self.ffn("enc_blocks/ffn", rows)
        elif btype == "dec":
            self.attn("dec_blocks/self_attn", rows, batch, kv("k"))
            self.attn("dec_blocks/cross_attn", rows, batch, kv("ck"))
            self.ffn("dec_blocks/ffn", rows)
        if btype in ("attn_block", "attn", "mla_block", "rec") and self.cfg.ffn != "none":
            self.ffn(f"{btype}/ffn", rows)
        return self.ops


def _batch_shards(cell, mesh) -> int:
    batch_specs = cell.in_specs[2 if cell.kind == "decode" else 1]
    name = "token" if cell.kind == "decode" else "tokens"
    spec = dict(("/".join(n), s) for n, s in tree_items(batch_specs))[name]
    return math.prod(mesh.shape[a] for a in _axes_of(spec[0])) if len(spec) else 1


def collective_ops(cell, cfg, shape, mesh) -> list[tuple[str, tuple, float]]:
    """Every collective of the cell's step on one chip: ``(kind, mesh axes,
    operand bytes)``, by the model in the module docstring."""
    M, bpe = mesh.shape["model"], torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    train = cell.kind == "train"
    state, state_specs = cell.args[0], cell.in_specs[0]
    params = _table(state.params, state_specs.params) if train else _table(state, state_specs)
    caches = (_table(cell.args[1], cell.in_specs[1]) if cell.kind == "decode" else None)
    batch = shape.global_batch // _batch_shards(cell, mesh)
    n = 1 if cell.kind == "decode" else shape.seq_len
    rows = batch * n
    walk = _ModelAxis(cfg, params, M, bpe)

    blocks = []                                            # the blocks' forward
    if cfg.family == "audio":
        if cell.kind != "decode":
            blocks += walk.block("enc", batch * shape.seq_len, batch, n, None) \
                * cfg.encdec.n_encoder_layers
        blocks += walk.block("dec", rows, batch, n, caches) * cfg.n_layers
    else:
        layout = block_layout(cfg)
        for btype in dict.fromkeys(layout):
            blocks += walk.block(btype, rows, batch, n, caches) * layout.count(btype)
    ops = [(k, MODEL, b) for k, b in blocks]
    D = cfg.d_model
    if _split(params["embed"][0], -2):                     # vocab-sharded lookup
        ops.append(("all-reduce", MODEL, rows * D * bpe))
    if not train:
        return ops
    head_split = (_split(params["unembed"][0], -1) if "unembed" in params
                  else _split(params["embed"][0], -2))       # tied: the embedding
    if head_split:
        ops += [("all-reduce", MODEL, 3 * rows * 4),       # the loss's max, sum, gold
                ("all-reduce", MODEL, rows * D * bpe)]     # the head's input gradient
    back = {"all-reduce": ("all-reduce", 1), "all-gather": ("reduce-scatter", M),
            "all-to-all": ("all-to-all", 1)}
    ops += [(back[k][0], MODEL, b * back[k][1]) for k, b in blocks]
    if cell.model.remat:
        ops += [(k, MODEL, b) for k, b in blocks]
    ops += _gradient_ops(state, state_specs, mesh)
    return ops


def _gradient_ops(state, state_specs, mesh) -> list[tuple[str, tuple, float]]:
    """The data axes' gradient reduction and ZeRO-1's parameter all-gather,
    once a step after the microbatches' gradients are accumulated."""
    da = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    data = mesh.shape[da[-1]]
    ops = []
    for (_, p), (_, ps), (_, ms) in zip(tree_items(state.params), tree_items(state_specs.params),
                                        tree_items(state_specs.opt["m"])):
        shards = math.prod(mesh.shape[a] for part in ps for a in _axes_of(part))
        local = math.prod(p.shape) * p.element_size() / shards
        if any(da[-1] in _axes_of(part) for part in ms):
            ops.append(("reduce-scatter", da[-1:], local))
            if len(da) > 1:
                ops.append(("all-reduce", da[:-1], local / data))
            ops.append(("all-gather", da[-1:], local / data))
        else:
            ops.append(("all-reduce", da, local))
    return ops


def axis_rate(mesh, axes) -> float:
    """NVLink when each group of ``axes`` stays within one node of
    ``GPUS_PER_NODE`` (entries numbered row-major), else InfiniBand."""
    names = list(mesh.axis_names)
    span = max(math.prod(mesh.shape[b] for b in names[names.index(a):]) for a in axes)
    return rl.NVLINK_BYTES_PER_S if span <= rl.GPUS_PER_NODE else rl.IB_BYTES_PER_S


def ring_bytes(kind: str, n: int, operand: float) -> float:
    """Bytes a ring over ``n`` chips moves through each chip's link."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * operand
    if kind == "all-gather":
        return (n - 1) * operand
    return (n - 1) / n * operand


def reckon_collectives(cell, cfg, shape, mesh) -> tuple[dict, float]:
    """(operand bytes a chip by kind, seconds at the axes' link rates)."""
    by_kind, seconds = dict.fromkeys(KINDS, 0.0), 0.0
    for kind, axes, nbytes in collective_ops(cell, cfg, shape, mesh):
        by_kind[kind] += nbytes
        n = math.prod(mesh.shape[a] for a in axes)
        seconds += ring_bytes(kind, n, nbytes) / axis_rate(mesh, axes)
    return by_kind, seconds


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             n_microbatches: int = 4, verbose: bool = True,
             unroll: bool = False, chunk: int = 1024) -> dict:
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    chips = int(np.prod(list(mesh.shape.values())))
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "multi_pod": multi_pod, "chips": chips,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    t0 = time.time()
    cell = make_cell(arch, shape_name, mesh=mesh, n_microbatches=n_microbatches,
                     chunk=chunk)
    if cell.kind == "train":
        model_flops = rl.model_flops_train(cell.n_params_active, cell.tokens_per_step)
    elif cell.kind == "prefill":
        model_flops = 2.0 * cell.n_params_active * cell.tokens_per_step
    else:
        model_flops = rl.model_flops_decode(cell.n_params_active, cell.tokens_per_step)

    work = _work(cfg, cell, shape)
    coll, t_coll = reckon_collectives(cell, cfg, shape, mesh)
    coll_total = sum(coll.values())
    per_chip = {"flops": work.flops / chips, "bytes": work.hbm_bytes / chips,
                "coll_bytes": coll_total}
    roof = rl.Roofline(flops=per_chip["flops"], hbm_bytes=per_chip["bytes"],
                       coll_bytes=coll_total, chips=1, model_flops=model_flops / chips,
                       ops_per_s=work.ops_per_s, route=work.route,
                       coll_bytes_per_s=(coll_total / t_coll if t_coll
                                         else rl.NVLINK_BYTES_PER_S)).as_dict()
    arg_bytes_per_dev = _sharded_arg_bytes(cell.args, cell.in_specs, mesh)
    mem, mem_source = device_memory()
    t_specs = time.time() - t0

    rec.update(
        status="ok", kind=cell.kind, unrolled=unroll,
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        n_params=cell.n_params, n_params_active=cell.n_params_active,
        tokens_per_step=cell.tokens_per_step,
        lower_s=None, compile_s=None, specs_s=round(t_specs, 3),
        memory_analysis=None,
        arg_bytes_per_device=arg_bytes_per_dev,
        arg_bytes_global=cell.arg_bytes,
        fits=arg_bytes_per_dev <= mem, device_memory_bytes=mem,
        device_memory_source=mem_source,
        cost_analysis_raw=None,
        per_chip=per_chip,
        collectives=coll,
        roofline=roof,
    )
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']}: specs "
              f"{t_specs:.2f}s flops={per_chip['flops']:.3e} bytes={per_chip['bytes']:.3e} "
              f"coll={coll_total:.3e} bottleneck={roof['bottleneck']} "
              f"args/dev={arg_bytes_per_dev / 2**30:.2f}GiB fits={rec['fits']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--unroll", action="store_true",
                    help="recorded only: the analytic work is whole-step")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[dryrun] {tag}: cached")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               n_microbatches=args.microbatches,
                               unroll=args.unroll, chunk=args.chunk)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[dryrun] done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
