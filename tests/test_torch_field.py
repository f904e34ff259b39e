"""The PyTorch port's field layer (`paillier_halo2_tpu_torch/ff`) against the
JAX package's `ff/field_jax.py`.

Inputs come from a numpy seed plus edge values (0, 1, p-1, p-2, R mod p) and
go through both packages; the JAX side runs its XLA path on the CPU (below
its 2048-lane Pallas threshold). Every comparison is exact: the values are
integers mod p. The kernel itself is held against this plain version on the
card in `test_torch_cuda.py`.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import mulmod

LANES = 128
SPECS = {"Fr": (f.FR, fj.FR), "Fq": (f.FQ, fj.FQ)}
CSRC = Path(__file__).resolve().parents[1] / "paillier_halo2_tpu_torch" / "csrc"


def _values(p: int, seed: int, n: int = LANES) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % p for w in words]
    edge = [0, 1, p - 1, p - 2, (1 << 256) % p]
    vals[: len(edge)] = edge
    return vals


def _pair(spec_name: str, seed: int):
    ts, js = SPECS[spec_name]
    xs = _values(ts.p, seed)
    return ts, js, xs, f.pack_ints(xs, "cpu"), jnp.asarray(fj.pack_ints(xs))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(f.to_ref_digits(t), np.asarray(j, dtype=np.uint32))


def test_layout_converters_round_trip():
    xs = _values(f.FQ.p, 0) + [(1 << 256) - 1, 1 << 255]
    ref = fj.pack_ints(xs)
    t = f.from_ref_digits(ref, "cpu")
    assert t.dtype == torch.int32 and t.shape == (8, len(xs))
    assert torch.equal(t, f.pack_ints(xs, "cpu"))
    assert np.array_equal(f.to_ref_digits(t), ref)
    assert f.unpack_ints(t) == xs == fj.unpack_ints(ref)
    # batch axes survive the conversion
    ref3 = ref.reshape(32, 2, -1)
    assert np.array_equal(f.to_ref_digits(f.from_ref_digits(ref3, "cpu")), ref3)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_field_jax(spec_name, op):
    ts, js, xs, a_t, a_j = _pair(spec_name, 1)
    ys = _values(ts.p, 2)[::-1]  # edge values meet every other edge value somewhere
    b_t, b_j = f.pack_ints(ys, "cpu"), jnp.asarray(fj.pack_ints(ys))
    got = getattr(f, op)(ts, a_t, b_t)
    assert _same(got, getattr(fj, op)(js, a_j, b_j))
    if op == "mont_mul":
        rinv = pow(1 << 256, -1, ts.p)
        assert f.unpack_ints(got) == [x * y * rinv % ts.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("op", ["neg", "mont_sqr", "to_mont", "from_mont", "mont_inv"])
def test_unary_ops_match_field_jax(spec_name, op):
    ts, js, _, a_t, a_j = _pair(spec_name, 3)
    assert _same(getattr(f, op)(ts, a_t), getattr(fj, op)(js, a_j))


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("e", [0, 1, 5, 0x1F3A5])
def test_mont_pow_fixed_matches_field_jax(spec_name, e):
    ts, js, _, a_t, a_j = _pair(spec_name, 4)
    assert _same(f.mont_pow_fixed(ts, a_t, e), fj.mont_pow_fixed(js, a_j, e))


def test_mont_mul_broadcasts_batch_axes():
    ts = f.FR
    xs = _values(ts.p, 5, 24)
    a = f.pack_ints(xs, "cpu").reshape(8, 2, 3, 4)
    c = f.pack_ints([7 * ts.r_mod_p % ts.p], "cpu").reshape(8, 1, 1, 1)
    got = f.unpack_ints(f.mont_mul(ts, a, c))
    assert got == [7 * x % ts.p for x in xs]


def test_cuda_constants_match_field_specs():
    """field.cuh's p limbs, R mod p limbs and -p^-1 mod 2^32 are the Python
    specs' values."""
    src = (CSRC / "field.cuh").read_text()
    for spec in (f.FR, f.FQ):
        body = re.search(r"struct %s \{(.*?)\n\};" % spec.name, src, re.S).group(1)
        arrays = [
            [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", block)]
            for block in re.findall(r"\{([^{}]*0x[^{}]*)\}", body)
        ]
        limbs = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]  # noqa: E731
        kinv = int(re.search(r"kInv = 0x([0-9a-f]+)u", body).group(1), 16)
        assert kinv == (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
        assert arrays == [limbs(spec.p), limbs(spec.r_mod_p)]


M32 = 0xFFFFFFFF


def _mac_row(t: list[int], a: list[int], b: int) -> None:
    """field.cuh's `mac_row` word by word: one carry chain over the even
    products, low word into t[j] then high word into t[j + 1], through t[8]
    and t[9]; then one over the odd products into t[1..9]. A carry out of
    t[9] would be lost."""
    for first, tail in ((0, (8, 9)), (1, (9,))):
        cf = 0
        for j in range(first, 8, 2):  # mad.lo.cc / madc.hi.cc / madc.lo.cc ...
            prod = a[j] * b
            s = t[j] + (prod & M32) + cf
            t[j], cf = s & M32, s >> 32
            s = t[j + 1] + (prod >> 32) + cf
            t[j + 1], cf = s & M32, s >> 32
        for k in tail:  # addc.cc / addc
            s = t[k] + cf
            t[k], cf = s & M32, s >> 32
        assert cf == 0, "carry out of the top word"


@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
def test_carry_chain_product_constants_and_schedule(spec):
    """The constants `redc_product_cc` and the `_lazy_cc` ops use (p's limbs,
    -p^-1 mod 2^32, 2p's limbs as `p2` forms them) and its row schedule, run
    word by word on inputs in [0, 2p) with edges: each result is the CIOS
    value (a*b + m*p) / R, below 2p, and no carry leaves the ten words."""
    p, R = spec.p, 1 << 256
    limbs = lambda v: [(v >> (32 * k)) & M32 for k in range(8)]  # noqa: E731
    pl = limbs(p)
    kinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    src = (CSRC / "field.cuh").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % spec.name, src, re.S).group(1)
    assert int(re.search(r"kInv = 0x([0-9a-f]+)u", body).group(1), 16) == kinv
    assert "mac_row(t, p, t[0] * F::kInv)" in src
    p2 = [((pl[i] << 1) | (pl[i - 1] >> 31 if i else 0)) & M32 for i in range(8)]
    assert p2 == limbs(2 * p) and 4 * p < R
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, size=(2, 64, 8), dtype=np.uint64)
    xs, ys = ([int.from_bytes(w.astype(np.uint32).tobytes(), "little") % (2 * p) for w in half]
              for half in words)
    edge = [0, 1, p - 1, p, 2 * p - 1]
    pairs = [(u, v) for u in edge for v in edge] + list(zip(xs, ys))
    for a, b in pairs:
        al, bl, t = limbs(a), limbs(b), [0] * 10
        for i in range(8):
            _mac_row(t, al, bl[i])
            _mac_row(t, pl, t[0] * kinv & M32)
            assert t[0] == 0
            t = t[1:] + [0]
        got = sum(w << (32 * k) for k, w in enumerate(t))
        m = (-a * b * pow(p, -1, R)) % R
        assert got == (a * b + m * p) // R and got < 2 * p and t[8] == 0


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "noncontiguous", "mismatch", "meta"],
)
def test_mont_mul_wrapper_rejects_bad_inputs(bad):
    a = f.pack_ints(_values(f.FR.p, 6, 16), "cpu")
    b = a.clone()
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "shape":
        a = a[:4]
    elif bad == "noncontiguous":
        a, b = a.t().contiguous().t(), b  # (8, 16) view with transposed strides
        assert not a.is_contiguous()
    elif bad == "mismatch":
        b = b[:, :8].contiguous()
    else:  # a device with neither the plain version nor the kernel
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        mulmod.mont_mul(f.FR, a, b)


def test_cpu_tensor_takes_the_plain_version():
    before = dict(mulmod.LAUNCHES)
    a = f.pack_ints(_values(f.FQ.p, 7, 32), "cpu")
    assert torch.equal(mulmod.mont_mul(f.FQ, a, a), mulmod.mont_mul_plain(f.FQ, a, a))
    assert mulmod.LAUNCHES == before  # no kernel launch counted on the CPU


def _strided_view(x: torch.Tensor, m: int, h: int) -> torch.Tensor:
    """The NTT's u: the first half of each butterfly block, `poly/ntt.py`."""
    return x.reshape(8, m, 2, h)[..., 0, :]


def _layout_cases():
    """(name, a, b) of the shapes the kernel's callers pass (CPU tensors)."""
    g, n = 5, 64
    slab = torch.arange(8 * g * n, dtype=torch.int32).reshape(8, g, n)
    chal = torch.arange(8 * n, dtype=torch.int32).reshape(8, 1, n) + 7
    x = torch.arange(8 * 4 * 2 * 8, dtype=torch.int32).reshape(8, 64)
    full = torch.arange(8 * 6 * 3, dtype=torch.int32).reshape(8, 6, 3)
    p = f.FR.limbs("p", "cpu").reshape(8, 1, 1)
    five = torch.arange(8 * 2 * 3 * 2 * 3 * 2, dtype=torch.int32).reshape(8, 2, 3, 2, 3, 2)
    return {
        "contiguous": (slab, slab + 1, [g * n]),
        "slab_plus_challenge": (slab, chal, [g, n]),
        "challenge_plus_slab": (chal, slab, [g, n]),
        "ntt_strided_view": (_strided_view(x, 4, 8), torch.zeros(8, 4, 8, dtype=torch.int32),
                             [4, 8]),
        "ntt_first_stage": (_strided_view(x, 32, 1), torch.zeros(8, 32, 1, dtype=torch.int32),
                            [32]),
        "narrowed_halves": (full.narrow(1, 0, 3), full.narrow(1, 3, 3), [9]),
        "neg_p_expanded": (p.expand(8, 6, 3), full, [18]),
        "one_lane": (torch.ones(8, 1, dtype=torch.int32), torch.ones(8, 1, dtype=torch.int32), [1]),
        "no_batch": (torch.ones(8, dtype=torch.int32), torch.full((8,), 2, dtype=torch.int32),
                     [1]),
        "five_dims_copied": (five.permute(0, 5, 4, 3, 2, 1), five[:, :1].permute(0, 5, 4, 3, 2, 1),
                             None),
    }


@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_add_sub_kernel_layout_matches_broadcast_tensors(case):
    """The shape, merged dimensions and strides that `add` and `sub` hand the
    kernel on a CUDA tensor, worked out here on CPU tensors of the callers'
    shapes: the shape and strides are `torch.broadcast_tensors`'s, and
    reading each operand's lanes through the merged layout, as the kernel
    does, gives the broadcast operand in the output's lane order, so the
    plain add of those lanes is the add of the operands."""
    a, b, want_sizes = _layout_cases()[case]
    ea, eb = torch.broadcast_tensors(a, b)
    shape = f.broadcast_shape(a.shape, b.shape)
    assert shape == tuple(torch.broadcast_shapes(a.shape, b.shape)) == tuple(ea.shape)
    sa, sb = f.broadcast_strides(a, shape), f.broadcast_strides(b, shape)
    for mine, view in ((sa, ea), (sb, eb)):  # strides of size-1 dimensions are arbitrary
        assert [s for s, n in zip(mine, shape) if n > 1] == [
            s for s, n in zip(view.stride(), shape) if n > 1]
    sizes, xa, xb = f.lane_layout(shape, sa, sb)
    if want_sizes is None:  # past MAX_DIMS: the wrapper copies, then reads one dimension
        assert len(sizes) > f.MAX_DIMS
        a, b = ea.contiguous(), eb.contiguous()
        sa, sb = list(a.stride()), list(b.stride())
        sizes, xa, xb = f.lane_layout(shape, sa, sb)
        want_sizes = [ea[0].numel()]
    assert sizes == want_sizes and len(sizes) <= f.MAX_DIMS
    lanes = ea[0].numel()
    got = [torch.as_strided(t, (8, *sizes), (s[0], *x)).reshape(8, lanes)
           for t, s, x in ((a, sa, xa), (b, sb, xb))]
    assert torch.equal(got[0], ea.reshape(8, lanes)) and torch.equal(got[1], eb.reshape(8, lanes))
    spec = f.FR
    ca, cb = (f.pack_ints([v % spec.p for v in f.unpack_ints(t)], "cpu") for t in got)
    va, vb = (f.pack_ints([v % spec.p for v in f.unpack_ints(t)], "cpu").reshape(shape)
              for t in (ea.contiguous(), eb.contiguous()))
    assert torch.equal(f.add_plain(spec, ca, cb), f.add(spec, va, vb).reshape(8, lanes))


def test_broadcast_shape_refuses_what_torch_refuses():
    with pytest.raises(ValueError):
        f.broadcast_shape((8, 3, 4), (8, 2, 4))
    assert f.broadcast_shape((8, 1, 4), (3, 1)) == (8, 3, 4)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_cpu_add_sub_take_the_plain_version(op):
    """On a CPU tensor `add` and `sub` are `add_plain` and `sub_plain`, and
    launch nothing; a device with neither raises."""
    before = dict(f.LAUNCHES)
    a = f.pack_ints(_values(f.FQ.p, 9, 32), "cpu")
    b = f.pack_ints(_values(f.FQ.p, 10, 32)[::-1], "cpu")
    plain = getattr(f, op + "_plain")
    assert torch.equal(getattr(f, op)(f.FQ, a, b), plain(f.FQ, a, b))
    assert torch.equal(getattr(f, op)(f.FQ, a.reshape(8, 4, 8), b[:, None, :8]),
                       plain(f.FQ, a.reshape(8, 4, 8), b[:, None, :8]))
    assert f.LAUNCHES == before
    with pytest.raises(RuntimeError):
        getattr(f, op)(f.FQ, a.to("meta"), b.to("meta"))
