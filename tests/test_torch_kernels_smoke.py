"""The port's kernel smoke lane (`utils/kernels_smoke.run_smoke`) on the
CPU: every case passes at the small batches (the kernels' plain versions
run, since the tensors lie on the CPU), and the cases are the JAX
function's, in its order, with its shapes. The JAX function's case names
are collected by running it with its `_timed` stubbed out, so no Pallas
kernel runs for that."""

import re

import numpy as np
import pytest

from quadruped_ctrl_tpu_torch.utils import kernels_smoke
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


def _case(line: str) -> list[str]:
    """A case's name as tokens, the status and time cut off, annotations in
    parentheses (kernel ids, routing, why a case is skipped) and the Pallas
    prefix of the JAX function names dropped."""
    name = re.sub(r"\s+(ok|BAD-VALUES|FAIL)\s.*$", "", line)
    return re.sub(r"\([^)]*\)", "", name).replace("_pallas", "").split()


@pytest.fixture(scope="module")
def jax_cases():
    from quadruped_ctrl_tpu.utils import kernels_smoke as jax_smoke

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_smoke, "_timed", lambda fn, *args: (np.zeros(1), 0.0))
        lines, _ = jax_smoke.run_smoke(full=False)
    return [_case(line) for line in lines]


def test_run_smoke_on_the_cpu_passes_the_jax_cases_in_order(jax_cases):
    lines, failed = kernels_smoke.run_smoke(full=False, device="cpu")
    assert failed == 0, "\n".join(lines)
    assert [_case(line) for line in lines] == jax_cases
    assert len(lines) == 16
    resid = [float(m[1]) for line in lines if (m := re.search(r"resid=(\S+)", line))]
    assert len(resid) == 8 and max(resid) < 0.05
    assert "n=144 (routed)" in lines[7] and "n=192 (not routed)" in lines[8]


def test_spd_batch_is_jacobi_scaled_spd():
    ks = kernels_smoke._spd_batch(3, 10, 20, 32, device="cpu")
    assert ks.shape == (10, 32, 32)
    k = ks.double().numpy()
    np.testing.assert_allclose(np.diagonal(k, axis1=1, axis2=2), 1.0, atol=1e-6)
    assert (np.linalg.eigvalsh(k) > 0).all()
    np.testing.assert_array_equal(k[8], k[0])          # tiled from G = 8 systems
    np.testing.assert_array_equal(k[:, 20:, 20:], np.broadcast_to(np.eye(12), (10, 12, 12)))
