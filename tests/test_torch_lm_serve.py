"""The port's LM serving launcher (``repro_torch.launch.serve``) against the
reference's: ``generate`` on the reference's weights and the same prompt
gives the same token ids at ``--smoke`` shapes (B 2, prompt 16, gen 8);
the command line runs on the CPU with ``--device cpu``, prints the
reference's ``[serve]`` line, and without ``--device`` refuses a host
without a GPU."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from _torch_lm import ref_params, smoke_cfgs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_LINE = re.compile(r"^\[serve\] generated (\d+) tokens in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\); sample: \[[\d\s]+\]$")


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen2-vl-7b"])
def test_generate_matches_reference(name):
    ref_cfg, cfg = smoke_cfgs(name)
    P, gen = 16, 8
    tree = ref_params(ref_cfg)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
    ref = ref_serve.generate(ref_build_model(ref_cfg, max_seq=P + gen, chunk=P),
                             jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(prompt), gen=gen)
    out = serve.generate(build_model(cfg, max_seq=P + gen, chunk=P),
                         lm_params_from_reference(tree, cfg, "cpu"),
                         torch.from_numpy(prompt), gen=gen)
    assert out.dtype == torch.int32 and out.shape == (2, gen)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def _serve_cli(*args, pre=""):
    code = (pre + "import runpy, sys\n"
            "sys.argv = ['serve'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_cli_runs_on_the_cpu_with_jax_absent():
    """``--smoke --device cpu`` exits 0 and prints the reference's line
    (4 x 32 tokens by default), with jax and the reference unimportable."""
    out = _serve_cli("--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                     pre="import sys\nsys.modules['jax'] = None\n"
                         "sys.modules['repro'] = None\n")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and SERVE_LINE.match(lines[0]), out.stdout
    assert SERVE_LINE.match(lines[0]).group(1) == "128"


def test_cli_without_device_refuses_a_host_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = _serve_cli("--arch", "llama3.2-3b", "--smoke")
    assert out.returncode != 0
    assert "CUDA device by default" in out.stderr and "device='cpu'" in out.stderr
    assert "[serve]" not in out.stdout


def test_model_entry_points_without_device_raise_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = smoke_cfgs("llama3.2-3b")
    m = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init_cache(2, 8, device="cuda")
