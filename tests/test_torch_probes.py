"""The last four TPU kernels' counterparts on the CPU: the keystream planes
(K5), the copy (K6), the u32 -> u8 emission (K7) and the pack-shift (K8).
Each plain PyTorch version is held to its Pallas kernel(s) in interpret
mode and to the reverie_tpu tool's NumPy / jnp want, byte for byte
(tolerance 0), and each probe's `run` works on the CPU at tiny sizes.  The
kernels' own tests (on a CUDA card only) are in test_torch_package.py,
which imports no jax and so also runs on the card's machine."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from reverie_tpu.crypto.kernels import aes_jax as aj
from reverie_tpu.crypto.kernels.aes_pallas import aes_ctr_planes_pallas
from reverie_tpu_torch.crypto.kernels import aes_planes, aes_tape
from reverie_tpu_torch import _build
from reverie_tpu_torch.tools import build_time, r2_measure, r4_bwroof, r4_extract_probe, r5_u8emit
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_JAX_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@functools.lru_cache(maxsize=None)
def tool(name):
    """reverie_tpu's tools/<name>.py, loaded by path.  Importing it sets
    JAX's compilation-cache config; the worker's values are restored."""
    saved = {k: getattr(jax.config, k) for k in _JAX_CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"reverie_tpu_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _keys(R, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (R, 8, 16), dtype=np.uint8)


# -- K5: keystream planes ------------------------------------------------------


def test_planes_match_pallas_kernel():
    """32 keys, B = 16, as tests/test_pallas_kernels.py runs the kernel."""
    pk = _keys(4)
    rkp = aj.round_key_planes(pk.reshape(-1, 16))
    want = np.asarray(aes_ctr_planes_pallas(rkp, 16, tile_b=16, interpret=True))
    got = aes_planes.aes_ctr_planes_ref(aes_tape.round_keys(pk, CPU), 16)
    assert got.dtype == torch.int32 and got.shape == (16, 8, 16, 1)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


@pytest.mark.parametrize("R, B", [(8, 21), (4, 1)])
def test_planes_match_xla_keystream_planes(R, B):
    """B not a multiple of 16: the stacked planes of aes_jax._keystream_planes."""
    pk = _keys(R, seed=R)
    rkp = jnp.asarray(aj.round_key_planes(pk.reshape(-1, 16)))
    mask = jnp.asarray(np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32))
    planes = aj._keystream_planes(rkp, jnp.asarray(aj.counter_planes(B)), mask)
    want = np.stack([np.asarray(p) for p in planes], axis=1)  # (16, 8, B, Kw)
    got = aes_planes.aes_ctr_planes(aes_tape.round_keys(pk, CPU), B)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_planes_post_processing_is_the_gf2_tape():
    """r2_measure's check at a small size: planes -> tape equals K1's tape
    and reverie_tpu's NumPy post-processing of the same planes."""
    pk = _keys(8, seed=3)
    rk = aes_tape.round_keys(pk, CPU)
    B = 5
    planes = aes_planes.aes_ctr_planes(rk, B)
    tape = r2_measure.planes_to_tape(planes, B)
    assert torch.equal(tape, aes_tape.aes_ctr_tape_gf2(rk, B * 128))
    want = _numpy_post(planes.numpy().view(np.uint32), B)
    np.testing.assert_array_equal(tape.numpy(), want)


def _numpy_post(planes, B):
    """tools/r2_measure.py:37-47 (numpy_post), which cannot be loaded
    without a TPU backend (the tool imports tpu_host at the top)."""
    Kw = planes.shape[-1]
    p = planes[:, ::-1, :B]
    words = np.transpose(p, (2, 0, 1, 3)).reshape(B * 128, Kw).astype(np.uint32)
    m1, m2_, m4 = np.uint32(0x55555555), np.uint32(0x33333333), np.uint32(0x0F0F0F0F)
    words = ((words & m1) << np.uint32(1)) | ((words >> np.uint32(1)) & m1)
    words = ((words & m2_) << np.uint32(2)) | ((words >> np.uint32(2)) & m2_)
    words = ((words & m4) << np.uint32(4)) | ((words >> np.uint32(4)) & m4)
    return np.ascontiguousarray(words).view(np.uint8).reshape(B * 128, Kw * 4)


# -- K6: copy --------------------------------------------------------------------


def _pallas_rows(kernel, x, out_shape, block_in, block_out, grid, index_in, index_out):
    """pl.pallas_call of a tool's kernel body in interpret mode, with the
    tool's BlockSpecs minus their memory space."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, x.dtype if out_shape == x.shape
                                               else jnp.uint8),
        grid=grid, in_specs=[pl.BlockSpec(block_in, index_in)],
        out_specs=pl.BlockSpec(block_out, index_out), interpret=True)(x))


@pytest.mark.parametrize("shape, dtype, tr", [((64, 256), np.uint8, 16),
                                               ((32, 128), np.uint32, 8)])
def test_copy_matches_pallas_copy_kernel(shape, dtype, tr):
    x = np.random.RandomState(4).randint(0, 2**31, shape).astype(dtype)
    want = _pallas_rows(tool("r4_bwroof")._copy_kernel, jnp.asarray(x), shape,
                        (tr, shape[1]), (tr, shape[1]), (shape[0] // tr,),
                        lambda i: (i, 0), lambda i: (i, 0))
    xt = torch.from_numpy(x.view(np.int32) if dtype == np.uint32 else x)
    got = r4_bwroof.copy(xt)
    assert got.data_ptr() != xt.data_ptr()
    np.testing.assert_array_equal(got.numpy().view(dtype), want)
    np.testing.assert_array_equal(r4_bwroof.copy_ref(xt).numpy(), xt.numpy())


# -- K7: u32 -> u8 emission ------------------------------------------------------


@pytest.mark.parametrize("kern, perm", [("kern_bitcast", False), ("kern_shift", False),
                                        ("kern_repeat", False), ("kern_concat", True)])
def test_u8emit_matches_pallas_kernels(kern, perm):
    T = r5_u8emit.T_CHECK
    x = r5_u8emit.tool_input(T)
    want = _pallas_rows(getattr(tool("r5_u8emit"), kern), jnp.asarray(x), (T, 2, 256),
                        (T, 128), (T, 2, 256), (1,), lambda i: (0, 0), lambda i: (0, 0, 0))
    got = r5_u8emit.u32_to_u8_rows(torch.from_numpy(x.view(np.int32)), perm).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r5_u8emit.tool_want(x, perm))


@pytest.mark.parametrize("perm", [False, True])
def test_u8emit_library_form_matches_plain(perm):
    w = torch.from_numpy(np.random.RandomState(2).randint(
        -2**31, 2**31, (5, 128)).astype(np.int32))
    assert torch.equal(r5_u8emit.u32_to_u8_rows_library(w, perm),
                       r5_u8emit.u32_to_u8_rows_ref(w, perm))


# -- K8: pack-shift --------------------------------------------------------------


@pytest.mark.parametrize("n", [1001, 1000])
def test_pack_shift_matches_pallas_kernels(n):
    """All three TPU bodies (tc = 8), and the tool's jnp pack_rows of the
    shifted bits; n % 8 == 0 still emits the remainder row."""
    rng = np.random.RandomState(n)
    x = rng.randint(0, 256, (n, 256)).astype(np.uint8)
    sh = rng.randint(0, 9, 256).astype(np.uint8)  # 8: the bit is always 0
    got = r4_extract_probe.pack_shift(torch.from_numpy(x), torch.from_numpy(sh)).numpy()
    assert got.shape == (n // 8 + 1, 256)
    probe = tool("r4_extract_probe")
    xs, shs = jnp.asarray(x), jnp.asarray(sh)
    np.testing.assert_array_equal(got, np.asarray(
        probe.pack_shift_pallas(xs, shs, tc=8, interpret=True)))
    for variant in ("u8", "mxu"):
        np.testing.assert_array_equal(got, np.asarray(probe.pack_shift_pallas2(
            xs, shs, tc=8, variant=variant, interpret=True)), err_msg=variant)
    bits = ((x.astype(np.uint32) >> sh[None, :]) & 1).astype(np.uint8)
    np.testing.assert_array_equal(got, np.asarray(probe.pack_rows(jnp.asarray(bits))))


def test_pack_shift_is_the_extractors_pack():
    """On the gathered columns, pack_shift is backend/host.py's GF(2)
    extraction pack of (x >> shift) & 1."""
    from reverie_tpu_torch.backend.host import _pack_rows_device

    x = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (77, 40)).astype(np.uint8))
    sh = torch.from_numpy(np.arange(40, dtype=np.uint8) % 8)
    assert torch.equal(r4_extract_probe.pack_shift(x, sh),
                       _pack_rows_device((x >> sh[None, :]) & 1))


# -- the probes on the CPU --------------------------------------------------------


def test_probe_r2_measure_runs_on_cpu():
    rows = r2_measure.run(CPU, blocks=(3, 4), reps=8)
    assert [r["blocks"] for r in rows] == [3, 4]
    assert all(r["planes_equal_gf2_tape"] and r["planes_ms"] is None for r in rows)


def test_probe_r4_bwroof_runs_on_cpu():
    rows = r4_bwroof.run(CPU, cases=(("u8", (40, 256), torch.uint8),
                                     ("u32", (10, 256), torch.int32)))
    assert [r["case"] for r in rows] == ["u8", "u32"]
    assert all(r["equal"] and r["copy_ms"] is None for r in rows)
    assert rows[1]["bytes"] == 10 * 256 * 4


def test_probe_r5_u8emit_runs_on_cpu():
    rows = r5_u8emit.run(CPU, t_time=9)
    assert [r["order"] for r in rows] == ["exact", "sigma"]
    assert all(r["equal_to_tool_want"] and r["kernel_ms"] is None for r in rows)


def test_probe_r4_extract_probe_runs_on_cpu():
    row = r4_extract_probe.run(CPU, n=1001, r=64, k=12)
    assert row["gather_equals_packall"] and row["packall_ms"] is None


def test_probe_mains_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (r2_measure, r4_bwroof, r5_u8emit, r4_extract_probe):
        with pytest.raises(RuntimeError, match="is_available"):
            mod.main()


def test_build_time_alternates_the_two_builds(monkeypatch):
    """The parallel build and one nvcc over every source, ROUNDS times
    each, alternating (the compilers stubbed out)."""
    calls = []
    monkeypatch.setattr(_build, "build", lambda: calls.append("parallel"))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build_time.subprocess, "run", lambda cmd, **kw: calls.append(cmd))
    rows = build_time.run()
    assert [r["way"] for r in rows] == ["parallel", "single_nvcc"] * build_time.ROUNDS
    srcs = [str(s) for s in _build.sources()]
    assert len(srcs) >= 8 and all(r["sources"] == len(srcs) for r in rows)
    cmd = calls[1]
    assert cmd[0] == "nvcc" and "-shared" in cmd and cmd[-len(srcs):] == srcs
    assert calls[0::2] == ["parallel"] * build_time.ROUNDS


def test_cpu_wrappers_launch_nothing():
    counts = (aes_planes.LAUNCHES, r4_bwroof.LAUNCHES, r5_u8emit.LAUNCHES,
              r4_extract_probe.LAUNCHES)
    rk = aes_tape.round_keys(_keys(4), CPU)
    assert aes_planes.aes_ctr_planes(rk, 2).shape == (16, 8, 2, 1)
    assert r4_bwroof.copy(torch.zeros(3, 5)).shape == (3, 5)
    assert r5_u8emit.u32_to_u8_rows(torch.zeros(2, 128, dtype=torch.int32)).shape == (2, 2, 256)
    x = torch.zeros(9, 8, dtype=torch.uint8)
    assert r4_extract_probe.pack_shift(x, torch.zeros(8, dtype=torch.uint8)).shape == (2, 8)
    assert counts == (aes_planes.LAUNCHES, r4_bwroof.LAUNCHES, r5_u8emit.LAUNCHES,
                      r4_extract_probe.LAUNCHES)


def test_wrappers_reject_bad_shapes_on_cpu():
    with pytest.raises(ValueError):
        aes_planes.aes_ctr_planes(torch.zeros(40, 11, 16, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        r5_u8emit.u32_to_u8_rows(torch.zeros(2, 64, dtype=torch.int32))
    with pytest.raises(ValueError):
        r4_extract_probe.pack_shift(torch.zeros(9, 8, dtype=torch.uint8),
                                    torch.zeros(4, dtype=torch.uint8))
