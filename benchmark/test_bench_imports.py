"""What the benchmark loads: never JAX nor the JAX package, and a
reference that imports nothing of the program."""

import subprocess
import sys

import pytest

from benchmark import run, spec

HERE = spec.HERE


def loaded_tops(code: str):
    """The top-level names of the modules a fresh interpreter holds after
    running ``code`` from the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({n.split('.')[0] for n in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(out.stdout.split())


def test_the_harness_and_the_port_load_no_jax():
    tops = loaded_tops(
        "import benchmark.run, benchmark.probe\n"
        "from benchmark.spec import driver\n"
        "driver('fast_rollout'); driver('jit_rollout')\n"
        "import oxide_control_torch.parallel.rollout, "
        "oxide_control_torch.policy, oxide_control_torch.suite")
    assert not tops & set(run.FORBIDDEN)
    assert "oxide_control_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    tops = loaded_tops("import benchmark.reference.kernel_env, "
                       "benchmark.reference.general")
    assert "oxide_control_torch" not in tops
    assert not tops & set(run.FORBIDDEN)
    for path in (HERE / "reference").rglob("*.py"):
        text = path.read_text()
        assert "import oxide_control" not in text, path
        assert "from oxide_control" not in text, path


def test_nothing_reads_the_jax_benchmark():
    names = ("BENCH" + "_", "bench" + ".py")
    for path in HERE.rglob("*.py"):
        text = path.read_text()
        assert not any(n in text for n in names), path


@pytest.mark.parametrize("names, found", [
    (["oxide_control_torch.ops", "torch"], []),
    (["oxide_control_tpu.model", "jaxtyping"], ["oxide_control_tpu"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
])
def test_the_forbidden_check_compares_whole_top_level_names(
        monkeypatch, names, found):
    fake = {n: None for n in names}
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == found
