"""Port vs JAX: SchwarzConfig's static level geometry over a sweep of N.

Integer outputs, so everything must match exactly.
"""

import dataclasses

import pytest

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu_torch.config import SchwarzConfig as TorchConfig

SIZES = [1, 31, 32, 33, 100, 1000, 1024, 4096, 4097, 40000, 65536, 262144, 1048576, 4194304]
VARIANTS = [
    {},
    {"level_headroom": 4.0},
    {"symv_kernel": "dense"},
    {"symv_kernel": "packed"},
    {"packed_symv_min_blocks": 100, "max_applied_levels": 3},
    {"solve_layout": "cm"},
    {"solve_layout": "rows"},
    {"inverse_dtype": "bfloat16"},
    {"inverse_dtype": "bfloat16", "symv_kernel": "packed"},
]

# JAX fields that select code the port does not carry yet; the port leaves
# them out so setting one fails loudly instead of doing nothing
NOT_CARRIED = {"use_pallas_symv", "pallas_inverse_group"}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_level_geometry_matches_jax(n, variant):
    kw = VARIANTS[variant]
    j, t = JaxConfig(**kw), TorchConfig(**kw)
    assert t.num_levels(n) == j.num_levels(n)
    assert t.level_capacities(n) == j.level_capacities(n)
    assert t.level_offsets(n) == j.level_offsets(n)
    assert t.total_capacity(n) == j.total_capacity(n)
    assert t.num_blocks(n) == j.num_blocks(n)
    assert t.use_packed_symv(n) == j.use_packed_symv(n)
    assert t.use_cm(n) == j.use_cm(n)


def test_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TorchConfig)}
    assert set(jf) - set(tf) == NOT_CARRIED
    assert tf == {k: v for k, v in jf.items() if k not in NOT_CARRIED}


@pytest.mark.parametrize("bad", [
    {"bank_size": 16}, {"closure_iters": 4}, {"symv_kernel": "x"},
    {"morton_normalization": "x"}, {"coarse_damping": 0.0}, {"coarse_damping": 1.5},
    {"solve_layout": "x"},
])
def test_post_init_rejects_what_jax_rejects(bad):
    with pytest.raises(AssertionError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        TorchConfig(**bad)


@pytest.mark.parametrize("bad", [
    {"inverse_kernel": "pallas"},
    # carried, but a storage dtype other than f32 / bf16 is refused (JAX
    # takes it silently)
    {"inverse_dtype": "float16"},
    {"use_pallas_symv": True},
    {"pallas_inverse_group": 16},
    # carried, but a zero collision budget is refused (JAX takes it silently)
    {"max_collision_per_vert": 0},
])
def test_options_not_carried_are_refused(bad):
    JaxConfig(**bad)
    with pytest.raises((TypeError, ValueError)):
        TorchConfig(**bad)
