"""Carry state between the reference and the port as numpy arrays.

Packed HVs travel as uint32 (the reference's dtype) and live in the port as
int32 tensors with the same bit patterns; an LM's params and caches travel
as nested dicts of arrays. Nothing here imports the reference package:
callers hand over ``np.asarray`` of its arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.blocking import ReferenceDB, reference_db_from_arrays
from repro_torch.core.cascade import CascadeOutput
from repro_torch.core.encoding import Codebooks
from repro_torch.core.fdr import FDRResult
from repro_torch.core.search import SearchResult
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.layers import ParamTree


def packed_to_torch(words, device="cpu") -> torch.Tensor:
    """uint32 (or int32) packed words -> int32 tensor, same bits."""
    a = np.ascontiguousarray(words)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True)).to(device)


def packed_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 packed-word tensor -> uint32 numpy array, same bits."""
    return words.cpu().numpy().view(np.uint32)


def codebooks_from_reference(id_hvs, level_hvs, tiebreak, dim: int,
                             device="cpu") -> Codebooks:
    return Codebooks(id_hvs=packed_to_torch(id_hvs, device),
                     level_hvs=packed_to_torch(level_hvs, device),
                     tiebreak=packed_to_torch(tiebreak, device), dim=int(dim))


def reference_db_from_numpy(hvs, pmz, charge, is_decoy, orig_idx, block_min,
                            block_max, block_charge, *, max_r: int,
                            device="cpu") -> ReferenceDB:
    return reference_db_from_arrays(
        np.asarray(hvs), pmz, charge, is_decoy, orig_idx, block_min,
        block_max, block_charge, max_r=max_r, device=device)


def search_result_to_numpy(res: SearchResult) -> dict[str, np.ndarray]:
    return {f: getattr(res, f).cpu().numpy() for f in SearchResult._fields}


def fdr_result_to_numpy(res: FDRResult) -> dict[str, np.ndarray]:
    return {f: getattr(res, f).cpu().numpy() for f in FDRResult._fields}


def stream_stats_to_numpy(st) -> dict[str, int] | None:
    """A serve StreamStats (or TotalStats) as plain ints by field name;
    None stays None."""
    if st is None:
        return None
    d = st._asdict() if hasattr(st, "_asdict") else dataclasses.asdict(st)
    return {f: int(v) for f, v in d.items()}


def cascade_output_to_numpy(out: CascadeOutput) -> dict:
    """A CascadeOutput as nested dicts of numpy arrays and ints: the merged
    result, both FDR results, ``identified_stage1``, the totals and, per
    stage (None when it did not run), its query indices, result, FDR,
    scanned rows and stream stats."""
    def stage(st):
        if st is None:
            return None
        return {"query_idx": np.asarray(st.query_idx),
                "result": search_result_to_numpy(st.result),
                "fdr": fdr_result_to_numpy(st.fdr),
                "scanned_rows": int(st.scanned_rows),
                "stream_stats": stream_stats_to_numpy(st.stream_stats)}

    return {"result": search_result_to_numpy(out.result),
            "open_fdr": fdr_result_to_numpy(out.open_fdr),
            "std_fdr": fdr_result_to_numpy(out.std_fdr),
            "identified_stage1": np.asarray(out.identified_stage1),
            "scanned_rows_total": int(out.scanned_rows_total),
            "scanned_bytes_total": out.scanned_bytes_total,
            "stage1": stage(out.stage1), "stage2": stage(out.stage2)}


# ---------------------------------------------------------------------------
# LM state (the reference's params and caches as nested dicts of numpy)
# ---------------------------------------------------------------------------


def _leaf_to_torch(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor. ``np.asarray`` of a bf16 JAX array has the
    ``ml_dtypes`` bfloat16 dtype: its bits travel as uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _module(d):
    """A nested dict of tensors as the port's parameter containers."""
    if all(isinstance(v, torch.Tensor) for v in d.values()):
        return nn.ParameterDict(d)
    if all(isinstance(v, dict) for v in d.values()):
        return nn.ModuleDict({k: _module(v) for k, v in d.items()})
    return ParamTree({k: _module(v) if isinstance(v, dict) else v for k, v in d.items()})


def _unstack(tree, n: int, device) -> list:
    """A reference stack (leaf ``[j]`` is layer ``j``) as ``n`` modules."""
    return [_module(_map_tree(lambda a: _leaf_to_torch(np.asarray(a)[j], device), tree))
            for j in range(n)]


def lm_params_from_reference(tree, cfg, device="cpu"):
    """The reference's LM params -> the port's: ``LMParams`` with one block
    per layer in ``block_layout`` order (the reference stacks them per
    block type: leaf ``[j]`` is the ``j``-th layer of that type), or, for
    the audio family, ``WhisperParams`` with its encoder and decoder stacks
    unstacked. Every leaf keeps its dtype."""
    def leaf(a):
        return _leaf_to_torch(a, device)

    if cfg.family == "audio":
        return W.WhisperParams(
            leaf(tree["embed"]), leaf(tree["pos_dec"]),
            _unstack(tree["enc_blocks"], cfg.encdec.n_encoder_layers, device),
            _unstack(tree["dec_blocks"], cfg.n_layers, device),
            _module(_map_tree(leaf, tree["enc_norm"])),
            _module(_map_tree(leaf, tree["dec_norm"])))
    layout = T.block_layout(cfg)
    stacks = {t: iter(_unstack(tree[t], n, device)) for t, n in T.type_counts(cfg).items()}
    blocks = [next(stacks[t]) for t in layout]
    unembed = tree.get("unembed")
    return T.LMParams(leaf(tree["embed"]), _module(_map_tree(leaf, tree["final_norm"])),
                      blocks, None if unembed is None else leaf(unembed), layout=layout)


def lm_reference_leaves(params) -> dict:
    """The port's LM params (or a copy of their structure, as the
    optimizer's ``m`` / ``v``) in the reference's layout, unstacked: nested
    dicts whose leaves are a tensor, or, for a leaf the reference stacks
    over layers, the list of the layers' tensors in stack order. The
    block types come from ``LMParams.layout``; the audio family stacks
    ``enc_blocks`` and ``dec_blocks``."""
    def tree(m):
        return {k: tree(v) if isinstance(v, nn.Module) else v for k, v in m.items()}

    def group(blocks):
        def join(ts):
            return {k: join([t[k] for t in ts]) if isinstance(ts[0][k], dict)
                    else [t[k] for t in ts] for k in ts[0]}
        return join([tree(b) for b in blocks])

    if isinstance(params, W.WhisperParams):
        return {"embed": params.embed, "pos_dec": params.pos_dec,
                "enc_blocks": group(params.enc_blocks),
                "dec_blocks": group(params.dec_blocks),
                "enc_norm": tree(params.enc_norm), "dec_norm": tree(params.dec_norm)}
    out = {"embed": params.embed, "final_norm": tree(params.final_norm)}
    if params.unembed is not None:
        out["unembed"] = params.unembed
    for t in dict.fromkeys(params.layout):
        out[t] = group([b for b, bt in zip(params.blocks, params.layout) if bt == t])
    return out


def lm_params_to_reference(params) -> dict:
    """The port's LM params in the reference's layout: nested dicts of
    tensors, the layers stacked per block type (``enc_blocks`` /
    ``dec_blocks`` for audio). Works on ``meta`` parameters too."""
    return _map_tree(lambda x: torch.stack([t.detach() for t in x]) if isinstance(x, list)
                     else x.detach(), lm_reference_leaves(params))


def lm_cache_from_reference(tree, device="cpu") -> dict:
    """The reference's per-type stacked cache -> the port's (same layout)."""
    return _map_tree(lambda a: _leaf_to_torch(a, device), tree)


def lm_cache_to_numpy(cache) -> dict:
    """The port's cache as nested dicts of numpy arrays; bfloat16 leaves
    come back as float32 (exact: numpy has no bfloat16 without
    ``ml_dtypes``)."""
    return _map_tree(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                     .detach().cpu().numpy(), cache)


# ---------------------------------------------------------------------------
# Training state (the reference's TrainState as nested dicts of numpy)
# ---------------------------------------------------------------------------


def train_state_from_reference(state, cfg, device="cpu"):
    """A reference ``TrainState`` as nested dicts of numpy, ``{"params",
    "opt": {"m", "v", "step"}, "step", "grad_err"}`` (``grad_err`` None or
    absent without compression), -> the port's ``TrainState``: params as
    ``lm_params_from_reference`` makes them, ``m`` / ``v`` / ``grad_err``
    in the same structure, the steps as int32 tensors."""
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_map

    params = lm_params_from_reference(state["params"], cfg, device)

    def like_params(tree):     # leaves that take no gradient, as adamw_init's
        return tree_map(torch.Tensor.detach, lm_params_from_reference(tree, cfg, device))

    opt = {"m": like_params(state["opt"]["m"]), "v": like_params(state["opt"]["v"]),
           "step": _leaf_to_torch(state["opt"]["step"], device)}
    err = state.get("grad_err")
    return TrainState(params=params, opt=opt, step=_leaf_to_torch(state["step"], device),
                      grad_err=None if err is None else like_params(err))


def train_state_to_reference(state) -> dict:
    """The port's ``TrainState`` as the nested dicts of numpy that
    ``train_state_from_reference`` reads, params, ``m``, ``v`` and
    ``grad_err`` in the reference's stacked layout; bfloat16 leaves come
    back as float32 (exact)."""
    def arrays(tree):
        return lm_cache_to_numpy(lm_params_to_reference(tree))

    def scalar(t):
        return t.detach().cpu().numpy()

    return {"params": arrays(state.params),
            "opt": {"m": arrays(state.opt["m"]), "v": arrays(state.opt["v"]),
                    "step": scalar(state.opt["step"])},
            "step": scalar(state.step),
            "grad_err": None if state.grad_err is None else arrays(state.grad_err)}
