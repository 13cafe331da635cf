"""Nothing the benchmark runs loads JAX or the JAX package, and nothing
in it reads the JAX package's old benchmark folder.  Top-level module
names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
import subprocess
import sys

from bench import run

FILES = sorted(p for p in run.BENCH.rglob("*.py") if "__pycache__" not in
               p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in FILES:
        bad = set(_imports(path)) & set(run.FORBIDDEN)
        assert not bad, (path, bad)


def test_nothing_reads_the_old_benchmark_folder():
    for path in FILES:
        if path.name == "test_bench_isolation.py":
            continue
        assert "benchmarks" not in path.read_text(), path


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import run, program, check, trace, traffic, ref_tm\n"
            "from bench.costs import round, train_epoch, votes\n"
            "import repro_torch.fl.runtime, repro_torch.core.tm\n"
            "import repro_torch.data.partition, repro_torch.random\n"
            "for m in %r: run.metric_reader(m)\n"
            "print(','.join(run.forbidden_modules()))"
            % (str(run.ROOT), str(run.ROOT / "src"),
               [m["name"] for m in __import__("json").loads(
                   (run.ROOT / "BENCHMARK.json").read_text())["per_layer"]]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["repro_torch.core.tm", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]
