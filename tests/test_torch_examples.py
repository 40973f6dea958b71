"""The port's examples on the CPU: ``examples/quickstart_torch.py --device
cpu`` prints the reference quickstart's lines when both search the same
spectra (the reference's ``jax.random`` dataset, handed to the port's
example in place of its numpy one: the search is bit-identical), and
``serve_lm_torch.py`` / ``train_lm_torch.py`` exit 0 with their lines.
``tests/test_torch_examples_e2e.py`` runs ``oms_search_e2e_torch.py``."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import os  # noqa: E402
import runpy  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from _torch_examples import ROOT, load_example, reference_dataset  # noqa: E402
from _torch_lm import one_torch_thread  # noqa: E402,F401


def test_quickstart_prints_the_reference_lines(monkeypatch, capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    qs = load_example("quickstart_torch")
    data = reference_dataset({"n_refs": 4096, "n_queries": 256, "seed": 0})
    monkeypatch.setattr(qs, "make_dataset", lambda cfg: data)
    qs.main(["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    assert len(ref) == 6 and ref[0].startswith("ingested 8704 rows into 17 blocks")
    assert port == ref


def _run(args, tmp_path):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_serve_lm_example_runs_on_the_cpu(tmp_path):
    out = _run([str(ROOT / "examples" / "serve_lm_torch.py"), "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1 and lines[0].startswith("[serve] generated 64 tokens in ")


def test_train_lm_example_runs_on_the_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = _run([str(ROOT / "examples" / "train_lm_torch.py"), "--steps", "2", "--ckpt-dir",
                str(ckpt), "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "[train] mesh {'data': 1, 'model': 1}; the step runs on cpu"
    assert lines[1].startswith("[loop] step 0 loss=")
    assert lines[-1].startswith("[train] done at step 2; loss ")
    assert any(p.name.startswith("step_") for p in ckpt.iterdir())


def test_examples_refuse_a_host_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart_torch", []), ("serve_lm_torch", []),
                       ("train_lm_torch", ["--steps", "1", "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_example(name).main(argv)
