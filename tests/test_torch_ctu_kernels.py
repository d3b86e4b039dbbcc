"""The port's CTU kernels K1-K4 against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; the twins are held
against the Pallas kernels run with interpret=True, on FULL arrays (junk
edge entries included), at atol 1e-5 for unit-variance f32 inputs.  The
CUDA kernels are held against the twins on the card by the tests marked
`cuda`, which skip without one (K1 bitwise).  On a GPU host without JAX
they run with

    python -m pytest tests/test_torch_ctu_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from somar_tpu_torch.ops import ctu_kernels as ck

try:    # the JAX reference; a GPU host may have no JAX (the cuda tests run)
    import jax.numpy as jnp
    from somar_tpu.ops import pallas_kernels as pk
except ImportError:
    jnp = pk = None

torch.set_num_threads(1)

SHAPE3 = (24, 16, 40)
SHAPE2 = (24, 40)
ATOL = 1e-5          # unit-variance f32 inputs; only rounding order differs
CASES = [(SHAPE3, 0), (SHAPE3, 1), (SHAPE3, 2), (SHAPE2, 0), (SHAPE2, 1)]


def _inputs(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture
def pallas():
    if pk is None:
        pytest.skip("needs the JAX package (jax) for the Pallas reference")
    return pk


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("limiting", [True, False])
@pytest.mark.parametrize("shape,ax", CASES)
def test_ppm_predict_twin_matches_pallas(pallas, shape, ax, limiting):
    s, u = _inputs(ax, 2, shape)
    want = pallas.ppm_predict_pallas(jnp.asarray(s), jnp.asarray(u),
                                 jnp.asarray(0.3, jnp.float32), ax, limiting,
                                 corr_coef_over_dx=0.1, interpret=True)
    got = ck.ppm_predict(torch.from_numpy(s), torch.from_numpy(u), 0.3, ax,
                         limiting, corr_coef_over_dx=0.1)
    _assert_close(got, want)


@pytest.mark.parametrize("ncorr", [1, 2])
@pytest.mark.parametrize("ax", [0, 1, 2])
def test_ctu_corr3_twin_matches_pallas(pallas, ax, ncorr):
    lo1, hi1, u, *cs = _inputs(10 + ax, 3 + ncorr, SHAPE3)
    want = pallas.ctu_corr3_pallas(jnp.asarray(lo1), jnp.asarray(hi1),
                               jnp.asarray(u), [jnp.asarray(c) for c in cs],
                               jnp.asarray(0.25, jnp.float32), ax,
                               interpret=True)
    got = ck.ctu_corr3(torch.from_numpy(lo1), torch.from_numpy(hi1),
                       torch.from_numpy(u), [torch.from_numpy(c) for c in cs],
                       0.25, ax)
    _assert_close(got, want)


MODES = {
    "div": dict(want_div=True),
    "rie": dict(want_rie=True),
    "rie+pre": dict(want_rie=True, want_pre=True),
    "pre": dict(want_rie=False, want_pre=True),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape,ax", CASES)
def test_ctu_final_twin_matches_pallas(pallas, shape, ax, mode):
    nc3 = 2 if len(shape) == 3 else 1
    lo1, hi1, adv, src, *c3 = _inputs(20 + ax, 4 + nc3, shape)
    src = src if len(shape) == 3 else None      # 2D: no source term
    flags = MODES[mode]
    want = pallas.ctu_final_pallas(
        jnp.asarray(lo1), jnp.asarray(hi1), jnp.asarray(adv),
        [jnp.asarray(c) for c in c3],
        None if src is None else jnp.asarray(src), 0.05, ax, interpret=True,
        **flags)
    got = ck.ctu_final(
        torch.from_numpy(lo1), torch.from_numpy(hi1), torch.from_numpy(adv),
        [torch.from_numpy(c) for c in c3],
        None if src is None else torch.from_numpy(src), 0.05, ax, **flags)
    _assert_close(got, want)


@pytest.mark.parametrize("shape,ax", CASES)
def test_riemann_fluxdiv_twin_matches_pallas(pallas, shape, ax):
    nf = 3 if len(shape) == 3 else 2
    adv, *flat = _inputs(30 + ax, 1 + 2 * nf, shape)
    pairs = list(zip(flat[0::2], flat[1::2]))
    want = pallas.riemann_fluxdiv_pallas(
        [(jnp.asarray(lo), jnp.asarray(hi)) for lo, hi in pairs],
        jnp.asarray(adv), ax, interpret=True)
    got = ck.riemann_fluxdiv(
        [(torch.from_numpy(lo), torch.from_numpy(hi)) for lo, hi in pairs],
        torch.from_numpy(adv), ax)
    _assert_close(got, want)


def test_ctu_final_rejects_empty_request():
    lo1, hi1, adv, c3 = (torch.from_numpy(a) for a in _inputs(1, 4, SHAPE2))
    with pytest.raises(ValueError):
        ck.ctu_final(lo1, hi1, adv, [c3], None, 0.05, 0, want_rie=False)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device than CPU or CUDA is refused, never sent
    to the twin."""
    s = torch.zeros(SHAPE2, device="meta")
    with pytest.raises(ValueError):
        ck.ppm_predict(s, s, 0.3, 0, True)
    with pytest.raises(ValueError):
        ck.riemann_fluxdiv([(s, s)], s, 1)


def test_launch_counts_count_only_kernel_launches():
    ck.reset_launch_counts()
    s, u = (torch.from_numpy(a) for a in _inputs(2, 2, SHAPE2))
    ck.ppm_predict(s, u, 0.3, 0, True)          # CPU: the twin, no launch
    assert ck.launch_counts() == {k.__name__: 0 for k in ck.KERNELS}


#: K1's launch shapes: the main paths' padded arrays (512x128x128 3D, the
#: 640x512 BeamGeneration level in 2D) and the small shapes of the tests
LAUNCH_SHAPES = [((136, 136, 520), 0, "march", 5),
                 ((136, 136, 520), 1, "march", 5),
                 ((136, 136, 520), 2, "row", 520),
                 ((520, 648), 0, "march", 4),
                 ((520, 648), 1, "row", 648),
                 ((5, 7, 9), 0, "march", 3),
                 ((6, 5), 1, "row", 5),
                 ((3, 2100), 1, "row", 700),
                 ((2100, 3), 0, "march", 4)]


@pytest.mark.parametrize("shape,ax,route,chunk", LAUNCH_SHAPES)
def test_ppm_launch_shape(shape, ax, route, chunk):
    """K1's launch shape is a pure function of the array shape and axis:
    a row segment of at most ROW_SEG faces along the contiguous axis (whose
    staging, 4 x ROW_SEG + 16 values, fits the 48 KB of shared memory the
    kernel may take in f64), else march chunks of at most MARCH_CHUNK[1]
    faces; only the last chunk of a line may be short, and a line has at
    most 65,535 chunks."""
    got = ck.ppm_launch_shape(shape, ax)
    assert got == (route, chunk)
    n = shape[ax]
    nchunk = -(-n // chunk)
    assert nchunk <= 65535 and (nchunk - 1) * chunk < n <= nchunk * chunk
    assert chunk <= (ck.ROW_SEG if route == "row" else ck.MARCH_CHUNK[1])
    assert (4 * ck.ROW_SEG + 16) * 8 <= 48 * 1024


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their twins on the same tensors
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _cuda_cases(device):
    gen = torch.Generator(device=device).manual_seed(5)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=device)

    out = []
    for shape, ax in CASES:
        s, u, lo1, hi1, adv, src, a, b = (rnd(shape) for _ in range(8))
        c3 = [a, b] if len(shape) == 3 else [a]
        for lim in (True, False):
            args = (s, u, 0.3, ax, lim, 0.1)
            out.append((ck.ppm_predict, ck.ppm_predict_plain, args, {}))
        if len(shape) == 3:
            args = (lo1, hi1, u, [a, b], 0.25, ax)
            out.append((ck.ctu_corr3, ck.ctu_corr3_plain, args, {}))
        for flags in MODES.values():
            args = (lo1, hi1, adv, c3, src, 0.05, ax)
            out.append((ck.ctu_final, ck.ctu_final_plain, args, flags))
        args = ([(lo1, hi1), (a, b), (s, u)], adv, ax)
        out.append((ck.riemann_fluxdiv, ck.riemann_fluxdiv_plain, args, {}))
    return out


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_twins(cuda_device, dtype):
    """Full arrays: K1 bitwise equal to its twin, K2-K4 within 1e-6
    max|input| (the kernels are built with -fmad=false and round as the
    twins do)."""
    for kern, plain, args, flags in _cuda_cases(cuda_device):
        args = _cast(args, dtype)
        scale = max(float(t.abs().max()) for t in _tensors(args))
        got, want = kern(*args, **flags), plain(*args, **flags)
        assert len(got) == len(want)
        limit = 0.0 if kern is ck.ppm_predict else 1e-6 * scale
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == dtype
            err = float((g - w).abs().max())
            assert err <= limit, (kern.__name__, err)


#: K1 on the edges of its two designs: each stencil axis; lines of 5 and 6
#: cells (every face clamped; a 5-cell line in march chunks of 3 and 2),
#: 23 and 45 (march chunks of 4 with a short last one, and interior
#: chunks), 2,100 (three row segments); 2D and 3D
K1_EDGES = [((5, 6, 7), 0), ((5, 6, 7), 1), ((6, 5, 7), 2), ((7, 6, 5), 2),
            ((23, 6, 9), 0), ((4, 45, 9), 1), ((3, 4, 45), 2),
            ((45, 33), 0), ((6, 23), 1), ((5, 5), 0), ((3, 2100), 1),
            ((2100, 3), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_edges_match_twin_bitwise(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for shape, ax in K1_EDGES:
        s, u = (torch.randn(shape, generator=gen, device=cuda_device,
                            dtype=dtype) for _ in range(2))
        for lim in (True, False):
            args = (s, u, 0.45, ax, lim, 0.2)
            got, want = ck.ppm_predict(*args), ck.ppm_predict_plain(*args)
            for g, w in zip(got, want):
                err = float((g - w).abs().max())
                assert err == 0.0, (shape, ax, lim, ck.ppm_launch_shape(
                    shape, ax), err)


@pytest.mark.cuda
def test_cuda_launch_counts(cuda_device):
    ck.reset_launch_counts()
    for kern, _, args, flags in _cuda_cases(cuda_device):
        kern(*args, **flags)
    assert all(n > 0 for n in ck.launch_counts().values())
