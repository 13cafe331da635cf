"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax, the JAX package ``repro`` or ``msgpack`` (the
GPU machine has neither jax nor msgpack); every module imports with them
blocked; entry points and every function that makes
tensors from host values default to the GPU and refuse to fall back to
the CPU; the port's float32 wire frames are byte-identical to the
reference codec's."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = _imports(path) & {"jax", "jaxlib", "repro", "msgpack"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', "
        "'msgpack'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro', 'msgpack') "
        "for k in sys.modules)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_refuses_a_gpu_less_host(monkeypatch):
    import torch
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()
    from repro_torch.launch import fed_serve, fed_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_train.main(["--clients", "2", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_serve.main(["--clients", "2", "--ckpt-dir", "unused"])


def _host_value_makers(tmp_path):
    from repro_torch import convert
    from repro_torch import random as tr
    from repro_torch.data import partition, synthetic
    from repro_torch.data.ingest import mirror, registry
    from repro_torch.launch import fed_train
    x, y, _ = synthetic.make_dataset("synthmnist", 50, tr.PRNGKey(0, "cpu"),
                                     side=12)
    return {
        "PRNGKey": lambda: tr.PRNGKey(0),
        "partition": lambda: partition.partition(
            x.numpy(), y.numpy(), 10, n_clients=2, experiment=1,
            key=tr.PRNGKey(1), n_train=2, n_test=2, n_conf=2),
        "make_dataset": lambda: synthetic.make_dataset(
            "synthmnist", 50, tr.PRNGKey(0), side=12),
        "registry.load": lambda: registry.load("synthmnist", n_samples=50),
        "registry.load_mirror": lambda: registry.load(
            "mnist", tmp_path, n_samples=50),
        "write_idx_mirror": lambda: mirror.write_idx_mirror(
            tmp_path, "synthmnist", 50, 12, 0),
        "write_leaf_mirror": lambda: mirror.write_leaf_mirror(
            tmp_path, "synthfemnist", 50, 8, 0, n_writers=4),
        "registry.load_leaf": lambda: registry.load(
            "femnist", tmp_path, n_samples=50, n_writers=4),
        "registry.load_stream": lambda: registry.load_stream(
            "synthfemnist", tmp_path, n_samples=50, n_writers=4),
        "build_scenario": lambda: fed_train.build_scenario(
            dataset="synthmnist", clients=2),
        "key_from_numpy": lambda: convert.key_from_numpy([0, 1]),
        "tm_params_from_numpy": lambda: convert.tm_params_from_numpy(
            np.ones((1, 2, 3, 4)), np.ones((1, 2, 3))),
        "engine_state_from_numpy": lambda: convert.engine_state_from_numpy(
            0, np.ones((1, 2, 3, 4)), np.ones((1, 2, 3)), np.zeros((2, 3))),
        "mlp_params_from_numpy": lambda: convert.mlp_params_from_numpy(
            {k: np.ones((2, 3)) for k in ("w1", "b1", "w2", "b2")}),
        "flis_client_state_from_numpy":
            lambda: convert.flis_client_state_from_numpy(
                {k: np.ones((2, 3)) for k in ("w1", "b1", "w2", "b2")},
                np.zeros(2)),
        "server_state_from_numpy": lambda: convert.server_state_from_numpy(
            np.zeros((2, 3)), (np.zeros((4, 3)), np.zeros(2))),
    }


@pytest.mark.parametrize("name", [
    "PRNGKey", "partition", "make_dataset", "registry.load",
    "registry.load_mirror", "write_idx_mirror", "write_leaf_mirror",
    "registry.load_leaf", "registry.load_stream", "build_scenario",
    "key_from_numpy", "tm_params_from_numpy", "engine_state_from_numpy",
    "mlp_params_from_numpy", "flis_client_state_from_numpy",
    "server_state_from_numpy"])
def test_tensors_from_host_values_default_to_the_gpu(monkeypatch, tmp_path,
                                                     name):
    """The partition draws on its key's device, so a GPU default for the
    key (``PRNGKey``) is the partition's too."""
    import torch
    make = _host_value_makers(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert not any(tmp_path.iterdir())   # nothing written before refusing


def test_codec_copy_is_byte_identical():
    """The port meters and decodes the very frames the reference codec
    writes for the float32 wire (every other codec:
    tests/test_torch_codec.py)."""
    from repro.fl.runtime import codec as jcodec
    from repro_torch.fl.runtime import codec
    rng = np.random.default_rng(0)
    for vec in (np.zeros(0, np.float32), rng.normal(size=7),
                rng.integers(0, 9, 300).astype(np.float32),
                np.array([np.inf, -0.0, 1e-45, np.nan], np.float32)):
        frame = codec.encode(vec, codec.CodecConfig())
        assert frame == jcodec.encode(vec, jcodec.CodecConfig())
        back = codec.decode(frame, len(vec), codec.CodecConfig())
        want = jcodec.decode(frame, len(vec), jcodec.CodecConfig())
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back.view(np.int32),
                                      want.view(np.int32))


def test_codec_is_the_references_numpy_code():
    """Below its docstring the port's codec is the reference module's
    code, line for line: every float step is the same numpy operation."""
    def body(path):
        tree = ast.parse(path.read_text())
        return [ast.dump(node) for node in tree.body[1:]]
    ref = ROOT / "src" / "repro" / "fl" / "runtime" / "codec.py"
    assert body(PKG / "fl" / "runtime" / "codec.py") == body(ref)
