"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name; the reference loads nothing of the program."""

import subprocess
import sys
import textwrap

from bench_h100.tests.conftest import ROOT

BLOCK = textwrap.dedent("""
    import importlib.abc, sys
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "midi_model_tpu"):
                raise ImportError(f"blocked: {name}")
            return None
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT_DIR)
""")


def run_py(body: str) -> subprocess.CompletedProcess:
    code = BLOCK.replace("ROOT_DIR", repr(str(ROOT))) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))


def test_a_cell_sets_up_and_runs_without_jax():
    """One serving cell's set-up and a short window at the tiny size on the
    CPU, JAX and the JAX package blocked: no loaded module's top-level name
    is one of them (``midi_model_tpu_torch`` is not ``midi_model_tpu``)."""
    out = run_py("""
        from bench_h100.tests import tiny
        from bench_h100 import common
        result, check = tiny.run("tv2o-medium.app_steady", seconds=1.0)
        assert "midi_model_tpu_torch" in sys.modules
        print("FORBIDDEN", common.forbidden_modules())
        print("CORRECT", result["correct"])
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout and "CORRECT True" in out.stdout, out.stdout[-2000:]


def test_the_reference_loads_nothing_of_the_program():
    out = run_py("""
        import bench_h100.reference.model, bench_h100.reference.judge
        import bench_h100.reference.grammar, bench_h100.reference.optim
        import bench_h100.reference.precision
        names = sorted(m for m in sys.modules if m.split(".")[0] == "midi_model_tpu_torch")
        print("PROGRAM", names)
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PROGRAM []" in out.stdout, out.stdout


def test_forbidden_compares_whole_top_level_names():
    from bench_h100 import common

    before = dict(sys.modules)
    try:
        sys.modules["midi_model_tpu_torch_x"] = object()
        sys.modules["jaxtyping"] = object()
        assert common.forbidden_modules() == [m for m in common.forbidden_modules()
                                              if m.split(".")[0] in common.FORBIDDEN]
        assert "jaxtyping" not in common.forbidden_modules()
        sys.modules["jax.numpy"] = object()
        assert "jax.numpy" in common.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in before:
                del sys.modules[k]


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          "tv2o-medium.app_steady", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT), env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                             "HOME": str(ROOT / "build")})
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout)
