"""The port's serve front against the reference's: ``coalesce_queries``
gives the reference's arrays; ``ResultCache.key`` is byte-equal for the
same HV (the port's int32 words against the reference's uint32) and the
LRU behaves the same; the ``MicroBatcher`` cases of the reference's serve
tests (coalescing, errors, cancelled futures, close, shared metrics,
deadline shedding, tenant round-robin) run on both packages' batchers with
the same outcome; and coalescing never changes an answer of the port's
search, which equals the reference's."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro.obs import Metrics as RefMetrics  # noqa: E402
from repro.serve import result_cache as ref_cache  # noqa: E402
from repro.serve import scheduler as ref_sched  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.obs import Metrics  # noqa: E402
from repro_torch.serve import result_cache as port_cache  # noqa: E402
from repro_torch.serve import scheduler as port_sched  # noqa: E402

CFG = dict(dim=512, max_r=32, q_block=8, n_levels=16)
DS = dict(n_refs=300, n_queries=24, seed=5)

IMPLS = {
    "reference": SimpleNamespace(sched=ref_sched, cache=ref_cache,
                                 Metrics=RefMetrics),
    "port": SimpleNamespace(sched=port_sched, cache=port_cache,
                            Metrics=Metrics),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _spec(m, pmz, n_peaks=3):
    return m.sched.QuerySpec(mz=np.full((n_peaks,), 500.0, np.float32),
                             intensity=np.ones((n_peaks,), np.float32),
                             pmz=float(pmz), charge=2)


def _echo(spectra):
    return list(np.asarray(spectra.pmz))


# ---------------------------------------------------------------------------
# coalesce_queries and the result cache, against the reference
# ---------------------------------------------------------------------------


def _random_specs(mod, seed):
    rng = np.random.default_rng(seed)
    return [mod.QuerySpec(mz=rng.uniform(200, 2000, n).astype(np.float32),
                          intensity=rng.exponential(1, n).astype(np.float32),
                          pmz=float(rng.uniform(400, 1800)),
                          charge=int(rng.integers(2, 4)))
            for n in rng.integers(0, 40, 9)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesce_queries_equals_reference(seed):
    got = port_sched.coalesce_queries(_random_specs(port_sched, seed))
    want = ref_sched.coalesce_queries(_random_specs(ref_sched, seed))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()
    assert got.mz.shape[1] >= 1
    for mod in (port_sched, ref_sched):
        with pytest.raises(ValueError, match="empty batch"):
            mod.coalesce_queries([])
        bad = mod.QuerySpec(mz=np.ones(3, np.float32),
                            intensity=np.ones(2, np.float32), pmz=1.0, charge=2)
        with pytest.raises(ValueError, match="length mismatch"):
            mod.coalesce_queries([bad])


@pytest.mark.parametrize("token", ["", '{"backend": "fused"}'])
def test_result_cache_key_bytes_equal_reference(token):
    rng = np.random.default_rng(3)
    hv_u32 = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    hv_u32[0] = 0xFFFFFFFF                           # sign bit set as int32
    hv_i32 = torch.from_numpy(hv_u32.view(np.int32).copy()).numpy()
    want = ref_cache.ResultCache.key(hv_u32, np.float32(812.25), 3, token)
    assert port_cache.ResultCache.key(hv_i32, np.float32(812.25), 3, token) == want
    assert port_cache.ResultCache.key(hv_u32, 812.25, 3, token) == want


def _cache_trace(m):
    reg = m.Metrics()
    c = m.cache.ResultCache(2, metrics=reg)
    seen = [c.get(b"a")]
    c.put(b"a", {"x": 1})
    c.put(b"b", {"x": 2})
    seen.append(c.get(b"a"))              # refreshes a: b is now oldest
    c.put(b"c", {"x": 3})                 # evicts b
    seen += [c.get(b"b"), c.get(b"c"), len(c)]
    c.clear()
    seen += [len(c), c.get(b"a")]
    return seen, reg.snapshot()


def test_result_cache_lru_equals_reference():
    assert _cache_trace(IMPLS["port"]) == _cache_trace(IMPLS["reference"])
    with pytest.raises(ValueError, match="capacity"):
        port_cache.ResultCache(0)


# ---------------------------------------------------------------------------
# MicroBatcher: the reference's cases, on both packages
# ---------------------------------------------------------------------------


def test_microbatcher_coalesces_and_routes_results(impl):
    batches = []

    def run_batch(spectra):
        batches.append(spectra.pmz.shape[0])
        return [float(p) * 2 for p in np.asarray(spectra.pmz)]

    with impl.sched.MicroBatcher(run_batch, max_batch=4, max_wait_s=0.05) as mb:
        futs = [mb.submit(_spec(impl, 100.0 + i)) for i in range(10)]
        results = [f.result(timeout=30) for f in futs]
    assert results == [pytest.approx(2 * (100.0 + i)) for i in range(10)]
    assert sum(batches) == 10 and max(batches) <= 4
    assert mb.n_queries == 10 and mb.n_batches == len(batches)


def test_microbatcher_propagates_errors_and_recovers(impl):
    calls = []

    def run_batch(spectra):
        calls.append(spectra.pmz.shape[0])
        if len(calls) == 1:
            raise RuntimeError("scan exploded")
        return list(range(spectra.pmz.shape[0]))

    with impl.sched.MicroBatcher(run_batch, max_batch=8, max_wait_s=0.01) as mb:
        bad = mb.submit(_spec(impl, 1.0))
        with pytest.raises(RuntimeError, match="scan exploded"):
            bad.result(timeout=30)
        good = mb.submit(_spec(impl, 2.0))
        assert good.result(timeout=30) == 0
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_spec(impl, 3.0))


def test_microbatcher_result_count_mismatch(impl):
    with impl.sched.MicroBatcher(lambda s: [1, 2, 3], max_batch=1,
                                 max_wait_s=0.0) as mb:
        fut = mb.submit(_spec(impl, 1.0))
        with pytest.raises(RuntimeError, match="returned 3 results"):
            fut.result(timeout=30)


def test_microbatcher_cancelled_future_records_latency_once(impl):
    release = threading.Event()

    def run_batch(spectra):
        release.wait(10)
        return _echo(spectra)

    with impl.sched.MicroBatcher(run_batch, max_batch=1, max_wait_s=0.0) as mb:
        doomed = mb.submit(_spec(impl, 1.0))
        assert doomed.cancel()
        release.set()
        ok = mb.submit(_spec(impl, 7.0))
        assert ok.result(timeout=30) == pytest.approx(7.0)   # worker alive
    assert mb.e2e_latency.count == 2 and mb.queue_wait.count == 2
    assert mb.queue_depth.value == 0


def test_microbatcher_error_batch_records_latency(impl):
    def run_batch(spectra):
        raise RuntimeError("scan exploded")

    with impl.sched.MicroBatcher(run_batch, max_batch=4, max_wait_s=0.01) as mb:
        futs = [mb.submit(_spec(impl, float(i))) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="scan exploded"):
                f.result(timeout=30)
    assert mb.e2e_latency.count == 3


def test_microbatcher_close_flushes_partial_batch_metrics(impl):
    with impl.sched.MicroBatcher(_echo, max_batch=64, max_wait_s=30.0) as mb:
        futs = [mb.submit(_spec(impl, float(i))) for i in range(3)]
        mb.close()
        assert [f.result(timeout=30) for f in futs] == [0.0, 1.0, 2.0]
    assert mb.n_batches == 1 and mb.n_queries == 3
    assert mb.batch_sizes.count == 1
    assert mb.batch_sizes.sum == pytest.approx(3.0)
    assert mb.e2e_latency.count == 3 and mb.queue_wait.count == 3
    assert mb.queue_depth.value == 0 and mb.queue_depth.max >= 3
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_spec(impl, 2.0))


def test_microbatcher_shared_metrics_registry(impl):
    reg = impl.Metrics()
    with impl.sched.MicroBatcher(_echo, max_batch=2, max_wait_s=0.0,
                                 metrics=reg) as mb:
        assert mb.submit(_spec(impl, 5.0)).result(timeout=30) == pytest.approx(5.0)
    snap = reg.snapshot()
    assert set(snap) == {"e2e_latency_s", "queue_wait_s", "batch_size",
                         "queue_depth", "shed_admit", "shed_expired"}
    assert snap["e2e_latency_s"]["count"] == 1
    assert snap["batch_size"]["count"] == 1
    assert snap["queue_depth"]["value"] == 0.0
    with pytest.raises(ValueError, match="max_batch"):
        impl.sched.MicroBatcher(_echo, max_batch=0)


def test_deadline_cold_batcher_admits_everything(impl):
    with impl.sched.MicroBatcher(_echo, max_batch=4, max_wait_s=0.0) as mb:
        assert mb.estimate_latency_s() == 0.0
        fut = mb.submit(_spec(impl, 3.0), deadline_s=5.0)
        assert fut.result(timeout=30) == pytest.approx(3.0)
    assert mb.shed_admit.value == 0 and mb.shed_expired.value == 0


def test_deadline_admission_shed(impl):
    release = threading.Event()
    ran = []

    def run_batch(spectra):
        release.wait(10)
        ran.append(spectra.pmz.shape[0])
        return _echo(spectra)

    with impl.sched.MicroBatcher(run_batch, max_batch=1, max_wait_s=0.0) as mb:
        blocker = mb.submit(_spec(impl, 1.0))
        queued = mb.submit(_spec(impl, 2.0))
        mb.e2e_latency.observe(0.5)
        assert mb.estimate_latency_s() >= 0.5
        doomed = mb.submit(_spec(impl, 3.0), deadline_s=0.01)
        with pytest.raises(impl.sched.DeadlineExceeded,
                           match="shed at admission"):
            doomed.result(timeout=30)
        ok = mb.submit(_spec(impl, 4.0), deadline_s=60.0)
        release.set()
        assert blocker.result(timeout=30) == pytest.approx(1.0)
        assert queued.result(timeout=30) == pytest.approx(2.0)
        assert ok.result(timeout=30) == pytest.approx(4.0)
    assert mb.shed_admit.value == 1 and mb.shed_expired.value == 0
    assert ran == [1, 1, 1]
    assert mb.e2e_latency.count == 4


def test_admission_probe_on_empty_queue(impl):
    with impl.sched.MicroBatcher(_echo, max_batch=4, max_wait_s=0.0) as mb:
        mb.e2e_latency.observe(10.0)
        assert mb.estimate_latency_s() >= 10.0
        fut = mb.submit(_spec(impl, 7.0), deadline_s=0.05)
        assert fut.result(timeout=30) == pytest.approx(7.0)
    assert mb.shed_admit.value == 0 and mb.shed_expired.value == 0
    assert mb.e2e_latency.count == 2


def test_deadline_expired_in_queue_shed(impl):
    release = threading.Event()
    served = []

    def run_batch(spectra):
        release.wait(10)
        served.extend(float(p) for p in np.asarray(spectra.pmz))
        return _echo(spectra)

    with impl.sched.MicroBatcher(run_batch, max_batch=1, max_wait_s=0.0) as mb:
        blocker = mb.submit(_spec(impl, 1.0))
        doomed = mb.submit(_spec(impl, 2.0), deadline_s=0.01)
        time.sleep(0.1)
        release.set()
        assert blocker.result(timeout=30) == pytest.approx(1.0)
        with pytest.raises(impl.sched.DeadlineExceeded, match="expired"):
            doomed.result(timeout=30)
    assert mb.shed_expired.value == 1 and mb.shed_admit.value == 0
    assert served == [1.0]
    assert mb.e2e_latency.count == 1 and mb.queue_depth.value == 0


def test_tenant_round_robin_fairness(impl):
    release = threading.Event()
    order = []

    def run_batch(spectra):
        release.wait(10)
        order.extend(float(p) for p in np.asarray(spectra.pmz))
        return _echo(spectra)

    with impl.sched.MicroBatcher(run_batch, max_batch=1, max_wait_s=0.0) as mb:
        futs = [mb.submit(_spec(impl, 0.0))]
        for i in range(4):
            futs.append(mb.submit(_spec(impl, 10.0 + i), tenant="bulk"))
        for i in range(2):
            futs.append(mb.submit(_spec(impl, 20.0 + i), tenant="interactive"))
        release.set()
        for f in futs:
            f.result(timeout=30)
    pos = {p: i for i, p in enumerate(order)}
    assert pos[10.0] < pos[11.0] < pos[12.0] < pos[13.0]
    assert pos[20.0] < pos[21.0] < pos[13.0]
    assert mb.n_queries == 7


def test_microbatcher_many_submitters(impl):
    """Eight threads submitting at once: every future resolves to its own
    answer and the counts add up (no lost update under contention)."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with impl.sched.MicroBatcher(_echo, max_batch=5, max_wait_s=0.001) as mb:
            results = {}

            def client(k):
                for i in range(25):
                    v = float(1000 * k + i)
                    results[v] = mb.submit(_spec(impl, v), tenant=f"t{k % 3}")

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert all(f.result(timeout=30) == pytest.approx(v)
                       for v, f in results.items())
    finally:
        sys.setswitchinterval(old)
    assert mb.n_queries == 200 and mb.e2e_latency.count == 200
    assert mb.batch_sizes.sum == pytest.approx(200.0)
    assert mb.queue_depth.value == 0


# ---------------------------------------------------------------------------
# Coalescing independence on the port's search
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    ds = make_dataset(LibraryConfig(**DS))
    path = str(tmp_path_factory.mktemp("front") / "store")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**CFG), ds.refs,
                                    path, chunk_rows=512)
    ref = ref_pipeline.OMSPipeline.from_store(path, ref_pipeline.OMSConfig(**CFG))
    port = pipeline.OMSPipeline.from_store(path, pipeline.OMSConfig(**CFG),
                                           device="cpu", resident=False,
                                           slab_rows=96)
    return ds, ref, port


def _payload_lines(r, n):
    def h(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    std_i, std_s, opn_i, opn_s = (h(r.std_idx), h(r.std_sim), h(r.open_idx),
                                  h(r.open_sim))
    return [json.dumps(
        {"std": {"idx": std_i[i].tolist(), "sim": std_s[i].tolist()},
         "open": {"idx": opn_i[i].tolist(), "sim": opn_s[i].tolist()}},
        sort_keys=True, separators=(",", ":")) for i in range(n)]


def test_microbatcher_coalescing_independence(pipes):
    """The same queries under max_batch 1, 3 and all, in two submit orders,
    through the port's streamed search: byte-identical responses per
    query, equal to the reference's search of the whole batch."""
    ds, ref, port = pipes
    n = 12
    q = ds.queries
    mz, inten, pmz, charge = (np.asarray(x)[:n] for x in
                              (q.mz, q.intensity, q.pmz, q.charge))

    def spec_for(i):
        keep = inten[i] > 0
        return port_sched.QuerySpec(mz=mz[i][keep], intensity=inten[i][keep],
                                    pmz=float(pmz[i]), charge=int(charge[i]))

    def run_batch(spectra):
        return _payload_lines(port.search(spectra).result, spectra.pmz.shape[0])

    want = _payload_lines(ref.search(ref_sched.coalesce_queries(
        [ref_sched.QuerySpec(mz=mz[i][inten[i] > 0],
                             intensity=inten[i][inten[i] > 0],
                             pmz=float(pmz[i]), charge=int(charge[i]))
         for i in range(n)])).result, n)
    rng = np.random.default_rng(11)
    for max_batch in (1, 3, n):
        for tag in range(2):
            order = rng.permutation(n) if tag else np.arange(n)
            with port_sched.MicroBatcher(run_batch, max_batch=max_batch,
                                         max_wait_s=0.02) as mb:
                futs = {int(i): mb.submit(spec_for(int(i))) for i in order}
                got = {i: f.result(timeout=60) for i, f in futs.items()}
            assert [got[i] for i in range(n)] == want, (max_batch, tag)


# ---------------------------------------------------------------------------
# Hot reload through the launcher
# ---------------------------------------------------------------------------


class _GrowingStdin:
    """Request lines for ``serve --hot-reload``: the first part, then, once
    every one of those requests has been searched (their ``serve.batch``
    spans closed), an appended build of the store and a wait of several
    watcher polls, then the rest."""

    def __init__(self, first, rest, grow, poll_s):
        self.first, self.rest, self.grow, self.poll_s = first, rest, grow, poll_s

    def __iter__(self):
        from repro_torch.obs import trace
        yield from self.first
        deadline = time.monotonic() + 60
        while sum(e.attrs["n"] for e in trace.current().events()
                  if e.name == "serve.batch") < len(self.first):
            assert time.monotonic() < deadline, "first requests never served"
            time.sleep(0.01)
        self.grow()
        time.sleep(20 * self.poll_s)
        yield from self.rest


def test_serve_hot_reload_answers_as_a_cold_restart(tmp_path, monkeypatch):
    """``serve --hot-reload`` on a streamed store that grows mid-session:
    requests served before the append answer as a cold serve of the old
    store, requests after it as the reference's cold serve of the grown
    store, and no request is dropped."""
    import contextlib
    import io
    import sys

    from repro.launch import oms as ref_oms
    from repro_torch.launch import oms as port_oms

    store = str(tmp_path / "store")
    common = ["--dim", "512", "--n-levels", "16", "--chunk-rows", "512"]
    serve = ["serve", "--store", store, "--max-r", "32", "--q-block", "8",
             "--slab-rows", "96", "--no-result-cache"]

    def run(mod, argv, stdin):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdin", stdin)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()) as err:
            mod.main(argv)
        return out.getvalue().splitlines(), err.getvalue()

    run(port_oms, ["build", "--store", store, "--refs", "200", "--seed", "1",
                   *common, "--device", "cpu"], io.StringIO())
    # the requests are noisy copies of the spectra the append will add
    reqs, _ = run(port_oms, ["queries", "--refs", "120", "--queries", "16",
                             "--seed", "3"], io.StringIO())
    first, rest = [x + "\n" for x in reqs[:8]], [x + "\n" for x in reqs[8:]]
    before, _ = run(port_oms, [*serve, "--device", "cpu"],
                    io.StringIO("\n".join(reqs) + "\n"))

    def grow():
        run(port_oms, ["build", "--store", store, "--append", "--refs", "120",
                       "--seed", "3", *common, "--device", "cpu"], io.StringIO())

    got, err = run(port_oms, [*serve, "--device", "cpu", "--hot-reload", "0.02",
                              "--trace", str(tmp_path / "t.jsonl")],
                   _GrowingStdin(first, rest, grow, 0.02))
    assert "1 hot-reloads" in err and "hot-reload: re-planned" in err
    after, _ = run(ref_oms, serve, io.StringIO("".join(rest)))
    assert got[:8] == before[:8] and got[8:] == after and len(got) == 16
    assert after != before[8:]              # the new spectra were found
