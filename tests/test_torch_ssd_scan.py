"""The SSD scan kernel's dispatch and wrapper on the CPU, and its
arithmetic in a CPU twin.

``ssm.ssd_chunked`` launches ``csrc/ssd_scan.cu`` (``kernels.ssd_scan``)
for CUDA tensors in bf16 or f32 with no gradient required, and runs
``ssd_chunked_plain`` for everything else; fake CUDA tensors
(``FakeTensorMode``) show which way it goes without a card.  The kernel
itself runs only on the card (``tests/test_torch_cuda_kernels.py -k
ssd``); here a twin of its arithmetic in PyTorch (the same splits of the
products into bf16 parts, the same chunk tiles) is held to the plain
version by the card tests' bound (``repro_torch.testing.ssd``).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.models import ssm
from repro_torch.testing import ssd as ssd_test

BF, F32, F64 = torch.bfloat16, torch.float32, torch.float64


def _counts():
    k = build.SSD_SCAN
    return (k.launches, k.builds, k.binds)


def _refuse(*a, **k):
    raise AssertionError("the kernel's wrapper was called")


@pytest.mark.parametrize("dtype", [F32, BF, F64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "state"])
def test_ssd_chunked_on_cpu_tensors_runs_the_plain_body(monkeypatch, dtype, initial):
    """CPU tensors take ``ssd_chunked_plain``, bit for bit, and touch no
    kernel object."""
    before = _counts()
    monkeypatch.setattr(ssd_lib, "ssd_scan", _refuse)
    ops = ssd_test.ssd_inputs(2, 37, 4, 2, 8, 16, dtype, "cpu", seed=1, initial=initial)
    if dtype == F64:
        ops = {k: None if v is None else v.double() for k, v in ops.items()}
    cd = BF if dtype == BF else ops["x"].dtype
    got = ssm.ssd_chunked(**ops, chunk=16, compute_dtype=cd)
    want = ssm.ssd_chunked_plain(**ops, chunk=16, compute_dtype=cd)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _counts() == before


def _fake_cuda_ops(dtype, requires_grad=False):
    """The scan's operands as ``ssd_inputs`` lays them out, on the fake
    card (under a ``FakeTensorMode``)."""
    b, L, H, G, N, dh = 1, 20, 4, 2, 8, 16
    conv = torch.empty((b, L, H * dh + 2 * G * N), dtype=dtype, device="cuda")
    x, Bm, Cm = torch.split(conv, [H * dh, G * N, G * N], dim=-1)
    return dict(x=x.reshape(b, L, H, dh),
                dt=torch.empty((b, L, H), device="cuda", requires_grad=requires_grad),
                A=torch.empty((H,), device="cuda"), Bm=Bm.reshape(b, L, G, N),
                Cm=Cm.reshape(b, L, G, N),
                initial_state=torch.empty((b, H, N, dh), device="cuda"))


# (dtype, dt requires grad, grad mode, the kernel runs)
DISPATCH = [
    (BF, False, True, True),
    (F32, False, True, True),
    (F64, False, True, False),   # float64: the plain body
    (F32, True, True, False),    # autograd: the plain body
    (BF, True, True, False),
    (F32, True, False, True),    # requires grad, but under no_grad
]


@pytest.mark.parametrize("dtype,req,grad,kernel", DISPATCH,
                         ids=["bf16", "f32", "f64", "f32_grad", "bf16_grad", "f32_no_grad"])
def test_ssd_chunked_dispatch_on_cuda_tensors(monkeypatch, dtype, req, grad, kernel):
    """On (fake) CUDA tensors: bf16 and f32 without a gradient go to the
    kernel's wrapper with ``ssd_chunked``'s arguments; float64 and
    autograd go to the plain body; neither path builds anything here."""
    calls = []
    monkeypatch.setattr(ssd_lib, "ssd_scan", lambda *a: calls.append(("kernel", a)))
    monkeypatch.setattr(ssm, "ssd_chunked_plain", lambda *a: calls.append(("plain", a)))
    before = _counts()
    with FakeTensorMode():
        ops = _fake_cuda_ops(dtype, requires_grad=req)
        with torch.set_grad_enabled(grad):
            ssm.ssd_chunked(ops["x"], ops["dt"], ops["A"], ops["Bm"], ops["Cm"], 16,
                            ops["initial_state"], dtype)
    assert [c[0] for c in calls] == ["kernel" if kernel else "plain"]
    assert calls[0][1][:6] == (ops["x"], ops["dt"], ops["A"], ops["Bm"], ops["Cm"], 16)
    assert _counts() == before


def test_ssd_scan_wrapper_refuses_before_building():
    """The wrapper's checks raise ValueError, before anything is built or
    launched, for CPU tensors, mixed devices, a shape outside the
    instantiated set, other dtypes, a strided innermost dim and unaligned
    rows."""
    before = _counts()
    scan = ssd_lib.ssd_scan
    cpu = ssd_test.ssd_inputs(1, 20, 4, 2, 8, 16, F32, "cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        scan(cpu["x"], cpu["dt"], cpu["A"], cpu["Bm"], cpu["Cm"], 16)
    with FakeTensorMode():
        ops = _fake_cuda_ops(BF)
        x, dt, A, Bm, Cm, s0 = ops.values()

        def cuda(shape, dtype=F32, stride=None):  # (slicing a fake CUDA tensor needs CUDA)
            if stride is None:
                return torch.empty(shape, dtype=dtype, device="cuda")
            return torch.empty_strided(shape, stride, dtype=dtype, device="cuda")

        with pytest.raises(ValueError, match="one CUDA device"):
            scan(x, dt, torch.zeros(4), Bm, Cm, 16)  # A on the CPU
        with pytest.raises(ValueError, match="no instantiation"):
            scan(x, dt, A, Bm, Cm, 32)  # chunk past every tile of (8, 16)
        with pytest.raises(ValueError, match="no instantiation"):
            scan(cuda((1, 20, 4, 8), BF), dt, A, Bm, Cm, 16)  # head dim 8
        with pytest.raises(ValueError, match="no instantiation"):
            scan(x, dt, A, torch.cat([Bm] * 3, -1), torch.cat([Cm] * 3, -1), 16)  # N 24
        with pytest.raises(ValueError, match="no instantiation"):
            scan(x, dt, A, Bm, Cm, 0)
        with pytest.raises(ValueError, match="compute dtype"):
            scan(x, dt, A, Bm, Cm, 16, compute_dtype=F32)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            scan(x.double(), dt, A, Bm.double(), Cm.double(), 16)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            scan(x, dt, A, Bm.float(), Cm.float(), 16)
        with pytest.raises(ValueError, match="dt, A and the initial state in float32"):
            scan(x, dt.double(), A, Bm, Cm, 16)
        with pytest.raises(ValueError, match="G dividing"):  # H 3, G 2
            scan(cuda((1, 20, 3, 16), BF), cuda((1, 20, 3)), cuda((3,)), Bm, Cm, 16)
        with pytest.raises(ValueError, match="initial state"):
            scan(x, dt, A, Bm, Cm, 16, cuda((1, 2, 8, 16)))
        with pytest.raises(ValueError, match="innermost stride"):
            scan(cuda((1, 20, 4, 16), BF, (5120, 256, 64, 4)), dt, A, Bm, Cm, 16)
        with pytest.raises(ValueError, match="16-byte aligned"):  # rows 34 bytes apart
            scan(cuda((1, 20, 4, 16), BF, (1360, 68, 17, 1)), dt, A, Bm, Cm, 16)
    assert _counts() == before


def test_every_port_ssm_configuration_is_instantiated():
    """(N, head dim, chunk) of every SSM configuration of the port, full
    and smoke, has a tile equal to its chunk, and a cached prefill's
    shorter chunk (min(L, ssm_chunk)) the smallest tile that holds it."""
    for arch in ("zamba2-7b-instruct", "zamba2-7b", "mamba2-370m"):
        for smoke in (False, True):
            cfg = get_arch(arch, smoke=smoke)
            N, dh, q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
            assert ssd_lib.chunk_tile(N, dh, q) == q, (arch, smoke)
            assert ssd_lib.chunk_tile(N, dh, 1) <= q
            assert cfg.ssm_heads % cfg.ssm_groups == 0
    assert ssd_lib.chunk_tile(64, 64, 100) == 128
    assert ssd_lib.chunk_tile(64, 64, 129) == 256
    with pytest.raises(ValueError):
        ssd_lib.chunk_tile(64, 64, 257)


# ------------------------------------------------------------ the twin
def _split3(v: torch.Tensor) -> tuple:
    """v = hi + mid + lo, three bf16 parts of an f32 (the kernel's split3)."""
    hi = v.to(BF).to(F32)
    r = v - hi
    mid = r.to(BF).to(F32)
    return hi, mid, (r - mid).to(BF).to(F32)


def _twin(ops: dict, chunk: int, one_bf16: bool = False) -> tuple:
    """The kernel's arithmetic, in PyTorch on the CPU: each chunk in its
    tile (rows past the chunk zero), the dual form's products of bf16
    values split into hi and lo bf16 parts (or, with ``one_bf16``, rounded
    to one, which the kernel must not do), the state and the weighted
    input as three bf16 parts, every product of parts summed exactly
    (float64) and rounded to f32 once, as a tensor-core sum is to f32.
    The cumulative log-decay is torch.cumsum's, as the plain version's on
    the same device is (the kernel's sequential f32 sum is the card's
    torch.cumsum; the card tests hold that part)."""
    x, dt, A, Bm, Cm, s0 = ops.values()
    b, L, H, dh = x.shape
    G, N = Bm.shape[2:]
    bf16 = x.dtype == BF
    tile = ssd_lib.chunk_tile(N, dh, chunk)
    grp = torch.arange(H) // (H // G)
    S = torch.zeros((b, H, N, dh)) if s0 is None else s0.clone()
    ys = []

    def exact(a, c):  # a product of f32 parts, summed exactly, rounded once
        return (a.double() @ c.double()).float()

    for p0 in range(0, L, chunk):
        nv = min(chunk, L - p0)

        def rows(t):
            out = t.new_zeros((b, tile) + t.shape[2:])
            out[:, :nv] = t[:, p0: p0 + nv]
            return out

        xc, dtc = rows(x).float(), rows(dt)
        Bh = rows(Bm)[:, :, grp].float().transpose(1, 2)  # [b, H, tile, N]
        Ch = rows(Cm)[:, :, grp].float().transpose(1, 2)
        cs = torch.cumsum(dtc * A, dim=1).transpose(1, 2)  # [b, H, tile]
        dec = torch.exp(cs[..., -1:] - cs)
        mask = torch.exp(cs[..., :, None] - cs[..., None, :]).tril()
        score = exact(Ch, Bh.transpose(-1, -2))
        xw = (xc * dtc[..., None]).transpose(1, 2)  # [b, H, tile, dh] f32
        if bf16:
            mask, score = mask.to(BF).float(), score.to(BF).float()
            M = mask * score
            hi = M.to(BF).float()
            lo = (M - hi).to(BF).float()
            # exact where lo is above bf16's subnormal floor (2^-133)
            assert float((hi + lo - M).abs().max()) < 2.0 ** -132
            X = xw.to(BF).float()
            y = exact(hi, X) if one_bf16 else (hi.double() @ X.double() + lo.double() @ X.double()).float()
        else:
            y = exact(mask * score, xw)
        parts = _split3(S)
        assert float((sum(q.double() for q in parts) - S.double()).abs().max()) < 2.0 ** -132
        inter = (sum(Ch.double() @ p.double() for p in parts)).float()
        y = y + inter * torch.exp(cs)[..., None]
        V = xw * dec[..., None]
        vparts = _split3(V)
        contrib = sum(Bh.transpose(-1, -2).double() @ p.double() for p in vparts).float()
        S = S * torch.exp(cs[..., -1])[..., None, None] + contrib
        ys.append(y.transpose(1, 2)[:, :nv])
    return torch.cat(ys, dim=1), S


# (b, L, H, G, N, dh, chunk): the instruct smoke (N 8, G 2), the smoke (N 16),
# a ragged last chunk, a chunk shorter than its tile (a cached prefill's
# min(L, ssm_chunk)) over three chunks and over one
TWIN_CASES = [
    (2, 45, 4, 2, 8, 16, 16),
    (2, 40, 8, 1, 16, 16, 16),
    (1, 33, 4, 2, 8, 16, 12),
    (2, 11, 4, 2, 8, 16, 11),
]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: "b{}_L{}_H{}_G{}_N{}_c{}".format(*c[:5], c[6]))
@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "state"])
def test_kernel_twin_holds_the_card_bound_against_the_plain_scan(case, dtype, initial):
    """The twin of the kernel's arithmetic against ``ssd_chunked_plain``
    within the bound the card holds the kernel to; in bf16 from a zero
    state the twin that rounds mask * scores to one bf16 misses it (the
    norm; a drawn initial state's terms outweigh the intra-chunk ones)."""
    b, L, H, G, N, dh, chunk = case
    for seed in range(3):
        ops = ssd_test.ssd_inputs(b, L, H, G, N, dh, dtype, "cpu", seed=seed, initial=initial)
        r = ssd_test.agreement(_twin(ops, chunk), ops, chunk)
        assert ssd_test.holds(r), r
        if dtype == BF and not initial:
            bad = ssd_test.agreement(_twin(ops, chunk, one_bf16=True), ops, chunk)
            assert bad["norm"] > 1, bad


@pytest.mark.parametrize("decay", [(-112.0, 0.1), (-1.0, 1e-3)], ids=["fast", "slow"])
def test_kernel_twin_at_extreme_decays(decay):
    """Decays near 0 (A -112, dt 0.1: e^-11.2 a step, the mask underflows
    within a chunk) and near 1 (A -1, dt 1e-3)."""
    for dtype in (BF, F32):
        ops = ssd_test.ssd_inputs(2, 45, 4, 2, 8, 16, dtype, "cpu", seed=5, decay=decay)
        r = ssd_test.agreement(_twin(ops, 16), ops, 16)
        assert ssd_test.holds(r), (dtype, r)


def test_split3_is_exact_on_f32_edges():
    """hi + mid + lo is the f32 value exactly: integers, powers of two,
    values with all 24 bits set and f32's largest finite, at every
    magnitude from 2^-100 up; below, within 2^-133 (f32 subnormals)."""
    v = torch.tensor([0.0, -0.0, 1.0, 3.0, 2.0 ** -126, 2.0 ** -149, 1 - 2.0 ** -24,
                      (2 - 2.0 ** -23) * 2.0 ** 100, -12345.678, 3.4028235e38 / 2],
                     dtype=F32)
    v = torch.cat([v, torch.randn(4096, generator=torch.Generator().manual_seed(0))
                   * torch.exp2(torch.randint(-60, 60, (4096,)).float())])
    parts = _split3(v)
    total = parts[0].double() + parts[1].double() + parts[2].double()
    big = v.abs() >= 2.0 ** -100
    assert torch.equal(total[big], v.double()[big])
    # below, bf16's subnormals (down to 2^-133) drop what is under 2^-133
    assert float((total - v.double()).abs().max()) < 2.0 ** -133


def test_model_prefill_on_cpu_never_reaches_the_kernel(monkeypatch):
    """The zamba2-7b-instruct smoke model's cached prefill and forward on
    the CPU run the plain scan once a mamba layer and never the kernel."""
    from repro_torch.models import transformer as T

    monkeypatch.setattr(ssd_lib, "ssd_scan", _refuse)
    plain = []
    real = ssm.ssd_chunked_plain
    monkeypatch.setattr(ssm, "ssd_chunked_plain", lambda *a: plain.append(1) or real(*a))
    cfg = get_arch("zamba2-7b-instruct", smoke=True)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    before = _counts()
    with torch.inference_mode():
        T.prefill(model, toks, max_len=24)
    assert len(plain) == cfg.n_layers
    T.forward(model, toks).sum().backward()  # autograd: the plain body too
    assert len(plain) == 2 * cfg.n_layers and _counts() == before
