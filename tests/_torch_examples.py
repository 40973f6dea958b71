"""Shared pieces of the tests that run the port's examples
(``examples/*_torch.py``) on the CPU."""
import importlib.util
import re
from pathlib import Path

import numpy as np

from repro_torch.data import spectra

ROOT = Path(__file__).resolve().parents[1]


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples`` is not a package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_dataset(cfg_kw: dict):
    """The reference's ``make_dataset`` (``jax.random`` draws) as the port's
    numpy dataset, so both packages search the same spectra."""
    from repro.data.spectra import LibraryConfig, make_dataset
    ds = make_dataset(LibraryConfig(**cfg_kw))

    def host(s):
        return spectra.SpectraSet(*(np.array(a) for a in s))

    return spectra.SyntheticDataset(host(ds.refs), host(ds.queries),
                                    *(np.array(a) for a in ds[2:]))


def mask_times(text: str) -> str:
    """Seconds and rates masked: ``1.23s`` -> ``<t>s``."""
    return re.sub(r"\d+\.\d+s\b", "<t>s", text)
