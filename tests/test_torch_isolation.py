"""The port stands alone: no JAX, no reference, and no quiet CPU runs.

``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor the
reference package ``repro`` (checked on the source, and by importing every
port module in a fresh interpreter), and the port's entry points raise
rather than run on the CPU when no device is asked for and no card exists.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.gal_lm import LMOrganization
from repro_torch.launch import train_lm_gal
from repro_torch.models import transformer as tfm
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            + "assert not bad, bad\n"
            + f"print({len(mods)})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(mods) > 20


@pytest.mark.parametrize("path", sorted(
    p for p in (PORT / "kernels" / "csrc").iterdir()
    if p.suffix in (".cu", ".cuh")), ids=lambda p: p.name)
def test_kernels_compute_in_their_own_body(path):
    """A kernel source or header includes the CUDA runtime, ``cuda.h``
    (the ``CUtensorMap`` type and enums that TMA needs) and the type
    headers, no library of finished kernels: no cuBLAS, cuDNN or
    CUTLASS/CuTe. wgmma, TMA and mbarriers are inline PTX."""
    includes = [m.group(1) for m in (
        re.match(r"\s*#\s*include\s*(\S+)", line)
        for line in path.read_text().splitlines()) if m]
    allowed = {"<cmath>", "<cstdint>", "<cuda.h>", "<cuda_runtime.h>",
               "<cuda_bf16.h>"}
    assert set(includes) <= allowed, includes
    assert includes or path.suffix == ".cuh", f"{path.name} includes nothing"


def test_port_calls_no_fused_library_op():
    """The port's path never reaches a fused library kernel or a compiled
    plain version: attention goes through K2 or the plain einsums."""
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for name in ("scaled_dot_product_attention", "torch.compile",
                     "cudnn", "flash_attn"):
            assert name not in text, f"{path.relative_to(ROOT)}: {name}"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3-8b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMOrganization(0, cfg, lambda t: t).init(gen, lr=1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"layers": {"attn": {"wq": np.zeros((2, 1, 1))}},
                         "embed": {"tok": np.zeros((cfg.vocab, 1))}}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm_gal.main([])
    # asked for by name, the CPU runs
    assert resolve_device("cpu") == torch.device("cpu")
    params = tfm.init_params(gen, cfg, device="cpu")
    assert params["embed"]["tok"].device.type == "cpu"
