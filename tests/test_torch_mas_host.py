"""The port's host MAS (``matcha_tpu_torch/ops/mas.py::maximum_path_numpy``
over ``native/mas/mas.cpp``) against its plain torch version and JAX's
``maximum_path_numpy``: equal paths, ties and ragged masks included, on
``tests/test_mas.py``'s cases and on seeded random problems. Its library
is built under ``build/matcha_tpu_torch/`` and never next to the source
(JAX's ``libmas.so`` lives there and is rebuilt by its mtime)."""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu.ops.mas import maximum_path_numpy as jax_maximum_path_numpy
from matcha_tpu_torch import ops as port_ops
from matcha_tpu_torch.ops import cuda_build
from matcha_tpu_torch.ops import mas as port_mas
from tests.test_mas import make_problem, oracle

REPO = Path(__file__).resolve().parents[1]


def lengths_mask(B, T_x, T_y, t_xs, t_ys, dtype=np.float32):
    return ((np.arange(T_x)[None, :, None] < np.asarray(t_xs)[:, None, None])
            & (np.arange(T_y)[None, None, :] < np.asarray(t_ys)[:, None, None])).astype(dtype)


def mas_cases():
    """(name, value, mask): test_mas.py's problems, its single-token rows
    and full mask, ties, and seeded ragged problems with T_x <= T_y."""
    rng = np.random.default_rng(1234)
    cases = [("default", *make_problem(rng)), ("cpp", *make_problem(rng, B=8, T_x=23, T_y=57))]
    value, mask = make_problem(rng, B=1, T_x=5, T_y=5)
    cases.append(("full_mask", value, np.ones_like(mask)))
    value = rng.normal(size=(3, 6, 12)).astype(np.float32)
    cases.append(("single_token_rows", value, lengths_mask(3, 6, 12, [1, 1, 3], [1, 7, 12])))
    ints = rng.integers(-2, 3, size=(4, 9, 20)).astype(np.float32)
    cases.append(("ties", ints, lengths_mask(4, 9, 20, [9, 4, 1, 7], [20, 11, 3, 7])))
    for seed in range(3):
        r = np.random.default_rng(100 + seed)
        B, T_x = int(r.integers(1, 6)), int(r.integers(1, 40))
        T_y = T_x + int(r.integers(0, 80))
        t_xs = r.integers(1, T_x + 1, size=B)
        t_ys = np.maximum(r.integers(1, T_y + 1, size=B), t_xs)
        cases.append((f"random_{seed}", (3 * r.normal(size=(B, T_x, T_y))).astype(np.float32),
                      lengths_mask(B, T_x, T_y, t_xs, t_ys)))
    return cases


CASES = {name: (value, mask) for name, value, mask in mas_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_host_mas_equals_reference_and_jax(name):
    value, mask = CASES[name]
    got = port_ops.maximum_path_numpy(value, mask)
    assert got.dtype == np.float32 and got.shape == value.shape
    want = port_mas.maximum_path_reference(torch.from_numpy(value), torch.from_numpy(mask))
    assert torch.equal(torch.from_numpy(got), want)
    assert np.array_equal(got, jax_maximum_path_numpy(value, mask))
    assert np.array_equal(got, oracle(value, mask))


def test_host_mas_takes_a_bool_mask():
    value, mask = CASES["ties"]
    got = port_mas.maximum_path_numpy(value, mask.astype(bool))
    assert np.array_equal(got, port_mas.maximum_path_numpy(value, mask))


def _digests(folder: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(folder.iterdir())}


def test_host_mas_builds_under_build_and_not_into_native(tmp_path, monkeypatch):
    """A fresh build lands in the build directory, keyed on the source's
    hash, and leaves ``native/mas/`` as it was."""
    before = _digests(REPO / "native" / "mas")
    assert port_mas.host_library_path().parent == REPO / "build" / "matcha_tpu_torch"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_mas, "_host_lib", None)
    value, mask = CASES["default"]
    assert np.array_equal(port_mas.maximum_path_numpy(value, mask), oracle(value, mask))
    built = [p.name for p in (tmp_path / "build").iterdir()]
    assert built == [port_mas.host_library_path().name] and built[0].startswith("libmas-")
    assert _digests(REPO / "native" / "mas") == before


def test_host_mas_raises_when_the_build_fails(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_mas, "HOST_SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(port_mas, "_host_lib", None)
    value, mask = CASES["default"]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_mas.maximum_path_numpy(value, mask)


def test_importing_ops_builds_nothing(tmp_path):
    """``matcha_tpu_torch.ops`` exports what ``matcha_tpu.ops`` does, and
    importing it compiles nothing: it succeeds with no compiler on PATH."""
    import matcha_tpu.ops as jax_ops

    code = ("import matcha_tpu_torch.ops as o, matcha_tpu_torch.ops.mas as m; "
            "assert m._host_lib is None; print(sorted(n for n in dir(o) if not n.startswith('_')))")
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    want = {"maximum_path", "maximum_path_numpy", "denormalize", "duration_loss",
            "fix_len_compatibility", "generate_path", "normalize", "sequence_mask"}
    assert want <= set(dir(jax_ops)) and want <= set(eval(out))
