"""The port's kernel modules (refign_tpu_torch/ops/{attention,dwconv}.py)
against the JAX package, and the port's import boundary.

On the CPU the port's wrappers run their plain versions; these are held
against the Pallas kernels in interpret mode and against the JAX default
arms, in fp32 at atol 1e-5.  The CUDA kernels themselves are checked
against the same plain versions on the card by ``chip_smoke.py``.
"""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops.attention import (fused_small_kv_attention,
                                      sra_attention as jax_sra_attention)
from refign_tpu.ops.dwconv import dwconv3x3_gelu as jax_dwconv3x3_gelu
from refign_tpu_torch.ops.attention import (sra_attention,
                                            sra_attention_backward,
                                            sra_attention_reference)
from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                         dwconv3x3_gelu_backward,
                                         dwconv3x3_gelu_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "refign_tpu_torch")


def _qkv(N, M, H, seed, B=2, D=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, n, H, D).astype(np.float32) for n in (N, M, M)]


@pytest.mark.parametrize("N,M,H", [(300, 17, 1), (333, 256, 2),
                                   (1000, 289, 2)])
def test_attention_plain_matches_pallas_interpret(N, M, H):
    q, k, v = _qkv(N, M, H, seed=N + M)
    B, D = q.shape[0], q.shape[-1]
    scale = D ** -0.5
    qf = (jnp.asarray(q) * scale).transpose(0, 2, 1, 3).reshape(B * H, N, D)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(B * H, M, D)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(B * H, M, D)
    want = np.asarray(fused_small_kv_attention(qf, kf, vf, interpret=True)
                      .reshape(B, H, N, D).transpose(0, 2, 1, 3))
    got = sra_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,M,H", [(300, 17, 1), (333, 256, 2),
                                   (1000, 289, 2)])
def test_attention_wrapper_matches_jax_einsum(N, M, H):
    q, k, v = _qkv(N, M, H, seed=7 * N + M)
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jax_sra_attention(*map(jnp.asarray, (q, k, v)), scale,
                                        use_pallas=False))
    got = sra_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_attention_wrapper_reads_strided_kv():
    """k and v as the two halves of one fused kv projection (strided views,
    as SRAttention passes them) give the same result as copies."""
    rng = np.random.RandomState(3)
    B, N, M, H, D = 2, 70, 17, 2, 64
    q = torch.from_numpy(rng.randn(B, N, H, D).astype(np.float32))
    kv = torch.from_numpy(rng.randn(B, M, 2, H, D).astype(np.float32))
    got = sra_attention(q, kv[:, :, 0], kv[:, :, 1], 0.125)
    want = sra_attention_reference(q, kv[:, :, 0].contiguous(),
                                   kv[:, :, 1].contiguous(), 0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _meta(*shape, requires_grad=False):
    return torch.empty(shape, device="meta", requires_grad=requires_grad)


def test_attention_off_cpu_launches_or_raises():
    """Off the CPU the wrapper never takes the plain version: shapes the
    kernel does not take raise before any build."""
    with pytest.raises(ValueError, match="head dim"):
        sra_attention(_meta(1, 8, 1, 32), _meta(1, 4, 1, 32),
                      _meta(1, 4, 1, 32), 1.0)
    with pytest.raises(ValueError, match="M <= 4096"):
        sra_attention(_meta(1, 8, 1, 64), _meta(1, 4097, 1, 64),
                      _meta(1, 4097, 1, 64), 1.0)
    # inputs that require grad take the same checks, before any build
    with pytest.raises(ValueError, match="head dim"):
        sra_attention(_meta(1, 8, 1, 32, requires_grad=True),
                      _meta(1, 4, 1, 32), _meta(1, 4, 1, 32), 1.0)
    with pytest.raises(ValueError, match="do must match q"):
        sra_attention_backward(_meta(1, 8, 1, 64), _meta(1, 4, 1, 64),
                               _meta(1, 4, 1, 64), _meta(1, 7, 1, 64), 1.0)
    with pytest.raises(TypeError):
        sra_attention(*(t.half() for t in (_meta(1, 8, 1, 64),
                                           _meta(1, 4, 1, 64),
                                           _meta(1, 4, 1, 64))), 1.0)


def _dw_inputs(C, seed, H=9, W=11, B=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 1, C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("C", [40, 128, 256])
def test_dwconv_plain_matches_pallas_interpret(C):
    x, w, b = _dw_inputs(C, seed=C)
    want = np.asarray(jax_dwconv3x3_gelu(*map(jnp.asarray, (x, w, b)),
                                         use_pallas=True, interpret=True))
    got = dwconv3x3_gelu_reference(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [40, 128, 256])
def test_dwconv_wrapper_matches_jax_default_arm(C, monkeypatch):
    monkeypatch.delenv("REFIGN_TPU_DWCONV_PALLAS", raising=False)
    x, w, b = _dw_inputs(C, seed=3 * C, H=7, W=13)
    want = np.asarray(jax_dwconv3x3_gelu(*map(jnp.asarray, (x, w, b))))
    got = dwconv3x3_gelu(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the OIHW view of the weight gives the same result
    w_oihw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got2 = dwconv3x3_gelu(torch.from_numpy(x), w_oihw, torch.from_numpy(b))
    torch.testing.assert_close(got2, got, rtol=0, atol=0)


def test_dwconv_off_cpu_launches_or_raises():
    x, w, b = _meta(1, 5, 5, 16), _meta(3, 3, 1, 16), _meta(16)
    with pytest.raises(ValueError, match="weight"):
        dwconv3x3_gelu(_meta(1, 5, 5, 16, requires_grad=True),
                       _meta(3, 3, 1, 8), b)
    with pytest.raises(ValueError, match="g must match x"):
        dwconv3x3_gelu_backward(x, w, b, _meta(1, 5, 4, 16))
    with pytest.raises(ValueError, match="weight"):
        dwconv3x3_gelu(x, _meta(3, 3, 1, 8), b)
    with pytest.raises(ValueError, match="contiguous"):
        dwconv3x3_gelu(_meta(1, 16, 5, 5).permute(0, 2, 3, 1), w, b)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax, flax nor
    any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import refign_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    refign_tpu_torch.__path__, 'refign_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "want = {'refign_tpu_torch.models.resnet', 'refign_tpu_torch.metrics',\n"
        "        'refign_tpu_torch.models.heads.deeplabv2',\n"
        "        'refign_tpu_torch.data.loader', 'refign_tpu_torch.data.module',\n"
        "        'refign_tpu_torch.tasks.seg_task',\n"
        "        'refign_tpu_torch.tasks.align_task', 'refign_tpu_torch.cli',\n"
        "        'refign_tpu_torch.config', 'refign_tpu_torch.parallel.mesh',\n"
        "        'refign_tpu_torch.utils.sparse_epe',\n"
        "        'refign_tpu_torch.utils.profiling', 'refign_tpu_torch.native'}\n"
        "assert want <= set(names), sorted(want - set(names))\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'flax')\n"
        "             or k.startswith(('jax.', 'flax.'))\n"
        "             or k == 'refign_tpu' or k.startswith('refign_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    pats = [re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M),
            re.compile(r"\brefign_tpu\."),
            re.compile(r"\bfrom\s+refign_tpu\s")]
    found = []
    for root, _, files in os.walk(PORT):
        if "build" in os.path.relpath(root, PORT).split(os.sep):
            continue
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                text = fh.read()
            found += [f"{path}: {p.pattern}" for p in pats if p.search(text)]
    assert not found, found
