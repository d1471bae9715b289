"""The port's OSD-0 and GF(2) elimination against the JAX package.

Inputs come from numpy seeds and go through both packages. The JAX side runs
as its own tests run it on the CPU: the XLA lanes elimination and the Pallas
kernel in interpret mode. The port runs its plain torch versions. Every
comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code, gf2
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.ops.osd_pallas import eliminate_pallas
from qldpc_tpu_torch.decoders.osd import OSDConfig, OSDDecoder
from qldpc_tpu_torch.ops.osd_cuda import eliminate, eliminate_rows, pack_rows

torch.set_num_threads(2)


def _as_i32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.uint32).view(np.int32))


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _permuted_systems(rng, code_name, B, p):
    code = get_code(code_name)
    H = code.Hx
    errors = (rng.random((B, code.n)) < p).astype(np.uint8)
    resid = (errors @ H.T) % 2
    orders = np.stack([rng.permutation(code.n) for _ in range(B)])
    Hp = np.stack([H[:, o] for o in orders])
    return H, Hp, resid


def test_pack_matches_jax_lanes_and_wraps_bit31(rng):
    n = 72  # three words; columns 31 and 63 land on bit 31
    bits = (rng.random((16, 9, n)) < 0.5).astype(np.uint8)
    bits[0, 0] = 0
    bits[0, 0, 31] = 1
    osd = JaxOSDDecoder(np.zeros((9, n), np.uint8), JaxOSDConfig(order=0))
    ref = np.asarray(osd._pack_lanes(jnp.asarray(bits))).transpose(2, 0, 1)
    got = pack_rows(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert np.array_equal(_as_u32(got), ref)
    # bit 31 alone: 2**31 as uint32 wraps to the most negative int32
    assert int(got[0, 0, 0]) == -(2**31)
    assert int(got[0, 0, 1]) == 0


@pytest.mark.parametrize("code_name, p", [("[[72, 12, 6]]", 0.08), ("steane", 0.2)])
def test_eliminate_matches_lanes_and_pallas(rng, code_name, p):
    H, Hp, resid = _permuted_systems(rng, code_name, 128, p)
    n = H.shape[1]
    osd = JaxOSDDecoder(H, JaxOSDConfig(order=0))
    A = osd._pack_lanes(jnp.asarray(Hp))
    b = jnp.asarray(resid.T, jnp.uint32)
    A1, b1, _rank, piv1 = osd._eliminate_lanes(A, b)
    A2, b2, piv2 = eliminate_pallas(A, b, n=n, batch_tile=128, interpret=True)

    for max_rank in (None, gf2.rank(H)):
        A3, b3, piv3 = eliminate(_as_i32(A), _as_i32(b), n, max_rank)
        assert np.array_equal(_as_u32(A3), np.asarray(A1))
        assert np.array_equal(_as_u32(b3), np.asarray(b1))
        assert np.array_equal(piv3.numpy(), np.asarray(piv1))
        assert np.array_equal(_as_u32(A3), np.asarray(A2))
        assert np.array_equal(_as_u32(b3), np.asarray(b2))
        assert np.array_equal(piv3.numpy(), np.asarray(piv2))


def test_eliminate_rows_is_sample_major_eliminate(rng):
    H, Hp, resid = _permuted_systems(rng, "[[72, 12, 6]]", 32, 0.08)
    A = pack_rows(torch.from_numpy(Hp))
    b = torch.from_numpy(resid.astype(np.int32))
    A1, b1, p1 = eliminate_rows(A, b, H.shape[1])
    A2, b2, p2 = eliminate(A.permute(1, 2, 0), b.T, H.shape[1])
    assert torch.equal(A1, A2.permute(2, 0, 1))
    assert torch.equal(b1, b2.T)
    assert torch.equal(p1, p2.T)


@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]"])
def test_osd0_solutions_match_jax(rng, code_name):
    code = get_code(code_name)
    H = code.Hx
    B = 100
    errors = (rng.random((B, code.n)) < 0.08).astype(np.uint8)
    syn = (errors @ H.T) % 2
    # rounded LLRs: many exact ties, which the stable order must break alike
    llrs = np.round(rng.normal(size=(B, code.n)), 1).astype(np.float32)
    hard = (rng.random((B, code.n)) < 0.05).astype(np.int8)
    ref = np.asarray(JaxOSDDecoder(H, JaxOSDConfig(order=0))(syn, llrs, hard))
    ref_pallas = np.asarray(
        JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="pallas", batch_tile=64))(
            syn, llrs, hard
        )
    )
    got = OSDDecoder(H, OSDConfig(order=0))(
        torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard)
    )
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), ref_pallas)
    # every solution reproduces its syndrome (the systems are in image(H))
    assert np.array_equal((got.numpy().astype(np.int64) @ H.T) % 2, syn)


def test_osd_out_of_slice_features_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OSDConfig(order=2)
    wide = np.zeros((8, 32 * 5 + 1), np.uint8)  # 6 words against 1: transform path
    wide[:, 0] = 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OSDDecoder(wide)
