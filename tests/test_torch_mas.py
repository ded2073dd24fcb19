"""The port's Monotonic Alignment Search against the JAX package.

``matcha_tpu_torch.ops.mas.maximum_path`` on CPU tensors runs its plain
version. It must be BIT-identical to the JAX package's ``scan`` version
(``maximum_path_jax``), to the Pallas kernel in interpret mode and, on
feasible inputs, to the numpy oracle of ``tests/test_mas.py``, ties
included: all of them add, max and compare the same f32 values in the
same order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.mas_pallas import maximum_path_pallas
from matcha_tpu.ops.mas_ref import maximum_path_jax
from matcha_tpu_torch.ops import mas
from matcha_tpu_torch.scripts import profile_mas
from tests.test_mas import assert_valid_path, make_problem, oracle


def _masks(t_xs, t_ys, T_x, T_y):
    t_xs, t_ys = np.asarray(t_xs), np.asarray(t_ys)
    return ((np.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (np.arange(T_y)[None, None, :] < t_ys[:, None, None])).astype(np.float32)


def _cases():
    rng = np.random.default_rng(7)
    value, mask = make_problem(rng, B=4, T_x=11, T_y=29)
    yield "random", value, mask
    value, mask = make_problem(rng, B=3, T_x=40, T_y=128)
    yield "random_wide", value, mask
    mask = _masks([37, 5, 1], [120, 5, 9], 40, 128)  # ragged, t_x == t_y, one token
    yield "ragged", rng.normal(size=mask.shape).astype(np.float32) * 3, mask
    yield "zeros_ties", np.zeros_like(mask), mask
    yield "integer_ties", rng.integers(-2, 3, size=mask.shape).astype(np.float32), mask
    mask = _masks([1, 1], [1, 17], 1, 17)  # a single token
    yield "single_token", rng.normal(size=mask.shape).astype(np.float32), mask
    mask = _masks([9, 0], [4, 6], 12, 16)  # t_x > t_y, and an empty row
    yield "infeasible_and_empty", rng.normal(size=mask.shape).astype(np.float32), mask


CASES = list(_cases())


@pytest.mark.parametrize("name,value,mask", CASES, ids=[c[0] for c in CASES])
def test_mas_bit_identical_to_jax(name, value, mask):
    got = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    want_scan = np.asarray(maximum_path_jax(jnp.asarray(value), jnp.asarray(mask)))
    want_pallas = np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask),
                                                 interpret=True))
    np.testing.assert_array_equal(got, want_scan)
    np.testing.assert_array_equal(got, want_pallas)
    if "infeasible" not in name:  # the oracle indexes row -1 for an empty row
        np.testing.assert_array_equal(got, oracle(value, mask))
        assert_valid_path(got, mask)


def test_mas_mask_dtype_and_no_grad():
    """The path comes back in the mask's dtype (float or bool); the value's
    gradient is cut; CPU calls do not count as kernel launches."""
    rng = np.random.default_rng(3)
    value, mask = make_problem(rng, B=2, T_x=9, T_y=21)
    v = torch.from_numpy(value).requires_grad_(True)
    before = mas.LAUNCHES["maximum_path"]
    as_float = mas.maximum_path(v, torch.from_numpy(mask))
    as_bool = mas.maximum_path(v, torch.from_numpy(mask).bool())
    assert as_float.dtype == torch.float32 and not as_float.requires_grad
    assert as_bool.dtype == torch.bool
    np.testing.assert_array_equal(as_bool.numpy(), as_float.numpy().astype(bool))
    assert mas.LAUNCHES["maximum_path"] == before


def test_mas_refuses_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mas.maximum_path(torch.zeros(1, 2, 2, device="meta"), torch.zeros(1, 2, 2, device="meta"))


@pytest.mark.parametrize("T_y", [1, 7, 33, 832, 2051])
def test_mas_layout_covers_every_t_x(T_y):
    """Every T_x the kernel takes gets the smallest instance whose one
    chain warp holds it, tiles of at least one row in the instance's row
    step, and shared memory within the block's 227 KB."""
    instances = (0,) + mas.CPL_INSTANCES
    for T_x in range(1, mas.MAX_T_X + 1):
        cpl, chain_warps, rows, smem = mas.mas_layout(T_x, T_y)
        assert 32 * cpl * chain_warps >= T_x > 32 * instances[instances.index(cpl) - 1]
        assert 1 <= rows <= mas.MAX_TILE_ROWS and rows % (8 if cpl <= 16 else 2) == 0
        assert smem <= mas.MAX_SMEM == 227 * 1024


def test_mas_layout_refuses_wider_text():
    assert mas.mas_layout(mas.MAX_T_X, 7)[0] == mas.CPL_INSTANCES[-1] == 128
    with pytest.raises(ValueError, match="at most 4096"):
        mas.mas_layout(mas.MAX_T_X + 1, 7)


def test_mas_layout_constants_match_the_kernel_source():
    """The geometry mas_layout mirrors is the one csrc/mas.cu compiles."""
    src = (Path(mas.__file__).parents[1] / "csrc" / "mas.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["MAX_TILE_ROWS"] == mas.MAX_TILE_ROWS
    assert const["MAX_SMEM"] == mas.MAX_SMEM
    assert const["BT_ROWS"] == mas.BT_ROWS
    instances = re.search(r"CPL_INSTANCES\[\] = \{([\d, ]+)\};", src).group(1)
    assert tuple(int(c) for c in instances.split(",")) == mas.CPL_INSTANCES
    launched = re.findall(r"MAS_CASE\((\d+)\)", src.split("switch (cpl)")[-1])
    assert tuple(int(c) for c in launched) == mas.CPL_INSTANCES


def test_profile_mas_inputs_and_no_card():
    """The profiler's inputs: the first row full, the lengths in the top
    quarter, the mask their rectangle; without a card it exits."""
    value, mask, t_xs, t_ys = profile_mas.mas_inputs(4, 40, 96, "cpu")
    assert value.shape == mask.shape == (4, 40, 96)
    assert (t_xs[0], t_ys[0]) == (40, 96) and min(t_xs) >= 30 and min(t_ys) >= 72
    assert mask.sum().item() == sum(a * b for a, b in zip(t_xs, t_ys))
    assert torch.equal(mas.maximum_path(value, mask), mas.maximum_path_reference(value, mask))
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_mas.main([])
