"""The port's top-level API and its three examples, on the CPU.

``beluga_tpu_torch`` re-exports the JAX package's ``__all__`` from the
port's modules of the same paths, and importing it builds no kernel.  The
examples (``examples/torch_*.py``) are the port's counterparts of
``examples/tutorial_1d.py``, ``fleet_demo.py`` and ``mega_demo.py``; they
import only torch, numpy and the port, and run on the card unless given
``device="cpu"``.

The tutorial's cycle takes its draws as inputs: fed the JAX tutorial's
draws (its ``jax.random`` normals and systematic uniform) and the same
particles, one cycle gives the JAX cycle's estimate within 1e-5 relative
(XLA's and PyTorch's ``exp`` and ``log`` differ in the last bits) and the
same resampled particles within one ulp of the motion's largest operand
(the same donors: the CDFs agree to a few ulp, and no position lies that
close to an edge here; XLA associates the motion's sum ``x + v·dt +
noise`` in its own order, which moves ~5% of the states by an ulp).  The
demos run a few steps at small sizes and hold every estimate to the
0.9 m / 30° gate themselves.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beluga_tpu
import beluga_tpu_torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
sys.path.insert(0, str(REPO))


def test_all_matches_the_jax_package():
    assert beluga_tpu_torch.__all__ == beluga_tpu.__all__
    assert beluga_tpu_torch.__version__ == beluga_tpu.__version__
    for name in beluga_tpu_torch.__all__:
        port, ref = getattr(beluga_tpu_torch, name), getattr(beluga_tpu, name)
        assert port.__name__ == ref.__name__, name
        assert port.__module__.replace("beluga_tpu_torch", "beluga_tpu") == ref.__module__
    assert callable(beluga_tpu_torch.resolve_device)


def test_star_import_builds_no_kernel_and_imports_no_jax():
    code = (
        "import sys\n"
        "ns = {}\n"
        "exec('from beluga_tpu_torch import *', ns)\n"
        "names = sorted(k for k in ns if not k.startswith('__'))\n"
        "import beluga_tpu_torch\n"
        "assert names == sorted(beluga_tpu_torch.__all__), names\n"
        "bad = [m for m in ('jax', 'beluga_tpu', 'triton', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "from beluga_tpu_torch.ops import _build\n"
        "assert not _build._loaded, sorted(_build._loaded)  # a library, once loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_examples_import_only_torch_numpy_and_the_port():
    assert [p.name for p in EXAMPLES] == ["torch_fleet_demo.py", "torch_mega_demo.py",
                                          "torch_tutorial_1d.py"]
    allowed = {"torch", "numpy", "beluga_tpu_torch", "__future__", "argparse", "dataclasses",
               "math", "os", "pathlib", "sys", "tempfile", "time"}
    for path in EXAMPLES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in allowed, f"{path.name}:{node.lineno} imports {name}"


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the examples run on it")
    from examples import torch_fleet_demo, torch_mega_demo, torch_tutorial_1d

    for main in (torch_tutorial_1d.main, torch_fleet_demo.main, torch_mega_demo.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


def test_tutorial_converges():
    from examples.torch_tutorial_1d import main

    assert main(device="cpu") < 1.0  # tests/test_checkpoint_and_tutorial.py:70-72


@pytest.mark.parametrize("t", [0, 12])
def test_tutorial_cycle_matches_the_jax_cycle_on_its_draws(t):
    from beluga_tpu.core.particles import make_from_states as j_make
    from examples import torch_tutorial_1d as port
    from examples import tutorial_1d as ref

    p = port.TutorialParams()
    n = p.number_of_particles
    rng = np.random.default_rng(t)
    init = (t + rng.normal(0.0, 3.0, n)).astype(np.float32)
    true_pos = float(t + 1)
    meas, mask = ref.sense(true_pos, ref.LANDMARKS, p.sensor_range)
    key = jax.random.PRNGKey(t)
    k_mot, k_res = jax.random.split(key)
    normals = np.array(jax.random.normal(k_mot, (n,)))
    u0 = np.array(jax.random.uniform(k_res, (), jnp.float32))

    j_particles, (j_mean, j_var) = ref.cycle(ref.TutorialParams(), key, j_make(jnp.asarray(init)),
                                             meas, mask)
    landmarks = torch.tensor(port.LANDMARKS, dtype=torch.float32)
    t_meas, t_mask = port.sense(true_pos, landmarks, p.sensor_range)
    particles, (mean, var) = port.cycle(p, landmarks, port.make_from_states(torch.as_tensor(init)),
                                        t_meas, t_mask, torch.as_tensor(normals),
                                        torch.as_tensor(u0))
    np.testing.assert_array_equal(t_meas.numpy(), np.asarray(meas))
    np.testing.assert_allclose(float(mean), float(j_mean), rtol=1e-5)
    np.testing.assert_allclose(float(var), float(j_var), rtol=1e-5)
    ulp = 2.0**-23 * (np.abs(init).max() + p.velocity * p.dt + np.abs(normals).max())
    np.testing.assert_allclose(particles.state.numpy(), np.asarray(j_particles.state),
                               rtol=0, atol=ulp)
    np.testing.assert_array_equal(particles.log_weight.numpy(),
                                  np.asarray(j_particles.log_weight))


def test_fleet_demo_passes_the_gate_on_the_cpu():
    from examples.torch_fleet_demo import GATE_POS_M, main

    out = main(batch=4, num_particles=256, steps=4, device="cpu")
    assert out["ranks"] == 1 and out["filters_per_s"] > 0
    assert out["worst_pos_m"] < GATE_POS_M and out["worst_yaw_deg"] < 30.0


def test_mega_demo_passes_the_gate_on_the_cpu():
    from examples.torch_mega_demo import GATE_POS_M, main

    out = main(n=4096, steps=8, device="cpu")
    assert out["particles"] == 4096 and out["steps"] == 8
    assert out["err_max_m"] < GATE_POS_M and out["yaw_err_max_deg"] < 30.0
    assert out["particle_updates_per_s"] > 0
