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
    stacks = {t: iter(_unstack(tree[t], n, device)) for t, n in T.type_counts(cfg).items()}
    blocks = [next(stacks[t]) for t in T.block_layout(cfg)]
    unembed = tree.get("unembed")
    return T.LMParams(leaf(tree["embed"]), _module(_map_tree(leaf, tree["final_norm"])),
                      blocks, None if unembed is None else leaf(unembed))


def lm_params_to_reference(params, cfg) -> dict:
    """The port's LM params in the reference's layout: nested dicts of
    tensors, the layers stacked per block type (``enc_blocks`` /
    ``dec_blocks`` for audio). Works on ``meta`` parameters too."""
    def tree(m):
        return {k: tree(v) if isinstance(v, nn.Module) else v.detach()
                for k, v in m.items()}

    def stack(blocks):
        trees = [tree(b) for b in blocks]

        def join(ts):
            return {k: join([t[k] for t in ts]) if isinstance(ts[0][k], dict)
                    else torch.stack([t[k] for t in ts]) for k in ts[0]}
        return join(trees)

    if cfg.family == "audio":
        return {"embed": params.embed.detach(), "pos_dec": params.pos_dec.detach(),
                "enc_blocks": stack(params.enc_blocks),
                "dec_blocks": stack(params.dec_blocks),
                "enc_norm": tree(params.enc_norm), "dec_norm": tree(params.dec_norm)}
    out = {"embed": params.embed.detach(), "final_norm": tree(params.final_norm)}
    if params.unembed is not None:
        out["unembed"] = params.unembed.detach()
    layout = T.block_layout(cfg)
    for t in T.type_counts(cfg):
        out[t] = stack([b for b, bt in zip(params.blocks, layout) if bt == t])
    return out


def lm_cache_from_reference(tree, device="cpu") -> dict:
    """The reference's per-type stacked cache -> the port's (same layout)."""
    return _map_tree(lambda a: _leaf_to_torch(a, device), tree)


def lm_cache_to_numpy(cache) -> dict:
    """The port's cache as nested dicts of numpy arrays; bfloat16 leaves
    come back as float32 (exact: numpy has no bfloat16 without
    ``ml_dtypes``)."""
    return _map_tree(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                     .detach().cpu().numpy(), cache)
