"""The domain of the projection-fused kernels K8 (``ops/scan_proj.py``).

A K8 block holds a whole chunk of all channels in shared memory, so the
port takes fewer layers than the JAX package's ``proj_scan_supported``
(d_inner <= 128): also 1 <= dt_rank <= 16, and the chunk's tile within an
H100 block's 232448 bytes, forward and backward. These tests hold the
predicate at its edges, show that an out-of-domain call raises on the CPU
as it does on the card (before any launch), and that a MambaV3 layer the
kernels cannot take runs the directional composition. The card's own
sizes (``proj_scan_fwd_smem`` / ``proj_scan_bwd_smem``) are held against
the mirror in ``tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from segmamba_tpu.ops.scan_pallas_proj import (
    proj_scan_supported as j_supported,
)
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.ops import scan_proj

N = 16


@pytest.mark.parametrize("E,rank,T,dtype,want", [
    (96, 3, 128, torch.float32, True),      # SegMamba's stage 0
    (128, 6, 128, torch.float32, True),     # the widest tile's largest rank
    (128, 7, 128, torch.float32, False),    # backward over the limit
    (128, 8, 128, torch.bfloat16, False),   # the same in bfloat16
    (128, 16, 64, torch.float32, True),
    (64, 16, 256, torch.float32, True),     # the widest tile at T = 256
    (96, 1, 256, torch.float32, False),
    (96, 3, 256, torch.bfloat16, False),    # the forward fits, not the bwd
    (129, 1, 32, torch.float32, False),
    (24, 17, 32, torch.float32, False),
    (24, 0, 32, torch.float32, False),
])
def test_proj_scan_supported_edges(E, rank, T, dtype, want):
    assert scan_proj.proj_scan_supported(E, rank, T, dtype) is want
    if want:   # the port's domain lies inside the JAX package's
        assert j_supported(E)


def test_proj_scan_supported_keeps_the_one_argument_form():
    """``proj_scan_supported(d_inner)`` asks at dt_rank 1 and the default
    chunk, as the JAX package's one-argument form does."""
    for E in (1, 24, 96, 128, 129, 192):
        assert scan_proj.proj_scan_supported(E) == j_supported(E)


def test_smem_grows_with_every_dimension():
    """The mirrored sizes grow with d_inner, dt_rank, T and the element
    size, so the predicate's domain is a down-set."""
    base = scan_proj._smem_bytes(64, 3, 64, 4)
    for args in ((96, 3, 64, 4), (64, 4, 64, 4), (64, 3, 96, 4)):
        assert all(b >= a for a, b in zip(base, scan_proj._smem_bytes(*args)))
    assert scan_proj._smem_bytes(64, 3, 64, 2)[0] < base[0]


def test_out_of_domain_call_raises_on_the_cpu():
    """A call the kernels cannot take raises on the CPU too, before any
    work; the same layer at a shorter chunk runs."""
    g = torch.Generator().manual_seed(3)
    E, rank, L = 128, 7, 128
    args = (torch.randn(1, L, E, generator=g),
            0.1 * torch.randn(E, rank + 2 * N, generator=g),
            0.3 * torch.randn(rank, E, generator=g), torch.zeros(E),
            -torch.rand(E, N, generator=g) - 0.5, torch.ones(E))
    with pytest.raises(ValueError, match="shared memory"):
        scan_proj.mamba_scan_proj(*args, chunk_size=128)
    out = scan_proj.mamba_scan_proj(*args, chunk_size=64)
    want = scan_proj.mamba_scan_proj_ref(*args, chunk_size=64)
    torch.testing.assert_close(out, want)


@pytest.mark.parametrize("d_model,expand,chunk,want", [
    (48, 2, 128, "proj"),    # d_inner 96, dt_rank 3
    (128, 1, 128, "dir"),    # d_inner 128, dt_rank 8: the backward's tile
    (128, 1, 64, "proj"),    # does not fit at T = 128, fits at T = 64
    (96, 2, 128, "dir"),     # d_inner 192
])
def test_model_routes_what_k8_cannot_take_to_dir(d_model, expand, chunk,
                                                 want):
    layer = MambaV3(d_model, expand=expand, nslices=4, scan_impl="proj",
                    scan_chunk=chunk)
    assert layer.composition("cpu") == want
    assert layer.composition("cuda") == want
