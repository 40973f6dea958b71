"""``examples/oms_search_e2e_torch.py --device cpu`` on the reference's
spectra (its ``jax.random`` dataset handed to the port's example): every
``[serve]`` batch and every backend of the port's registry reports the
identifications the reference's pipeline makes on the same spectra; the
lines' shape with times masked."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import re  # noqa: E402

from _torch_examples import load_example, mask_times, reference_dataset  # noqa: E402
from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro_torch.core import backends  # noqa: E402


def test_every_backend_reports_the_reference_identifications(monkeypatch, capsys):
    import repro.core as RC
    from repro.data.spectra import LibraryConfig
    from repro.data.spectra import make_dataset as ref_make_dataset
    ref_ds = ref_make_dataset(LibraryConfig(n_refs=8192, n_queries=512, seed=1))
    ref_pipe = RC.OMSPipeline(RC.OMSConfig(dim=2048, max_r=512, q_block=16), ref_ds.refs)
    ids = int(ref_pipe.search(ref_ds.queries).open_fdr.n_accepted)

    ex = load_example("oms_search_e2e_torch")
    data = reference_dataset({"n_refs": 8192, "n_queries": 512, "seed": 1})
    monkeypatch.setattr(ex, "make_dataset", lambda cfg: data)
    ex.main(["--device", "cpu"])
    lines = mask_times(capsys.readouterr().out).splitlines()
    names = backends.names()
    assert len(names) == 7 and len(lines) == 1 + 3 + len(names) + 1
    assert lines[0] == f"[ingest] {ref_pipe.db.n_rows} rows, {ref_pipe.db.n_blocks} blocks"
    assert lines[1:4] == [f"[serve] batch {i}: 512 queries in <t>s, ids={ids}"
                          for i in range(3)]
    assert lines[4:-1] == [f"[backend {n:10s}] <t>s ids={ids}" for n in names]
    assert re.fullmatch(r"\[top-k\] recall@1=0\.\d{3} recall@4=0\.\d{3}", lines[-1])
