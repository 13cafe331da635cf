"""Each example of ``repro_torch.examples`` (the reference's
``examples/*.py`` on the port) once on the CPU, at small arguments."""
import numpy as np
import pytest

from test_torch_gpu import one_torch_thread  # noqa: F401


def test_example_quickstart(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu"])
    assert 0 <= out["accuracy"] <= 1 and out["confidence"].shape == (10,)
    assert len(out["history"]) == 2
    assert out["comm_mb"][0] == pytest.approx(2 * 5 * (50 * 4 + 4) / 1e6)
    assert "round 1: mean acc" in capsys.readouterr().out


def test_example_federated_training(capsys):
    from repro_torch.examples import federated_training
    out = federated_training.main(["--rounds", "1", "--clients", "6",
                                   "--dataset", "synthmnist", "--device",
                                   "cpu"])
    assert len(out["tpfl"]) == len(out["fedavg"].accuracy) == \
        len(out["fedtm"].accuracy) == 1
    assert "FedTM  acc/round" in capsys.readouterr().out


def test_example_multiarch_train(capsys):
    from repro_torch.configs import registry as archs
    from repro_torch.examples import multiarch_train
    out = multiarch_train.main(["--steps", "1", "--device", "cpu"])
    assert list(out) == list(archs.ARCHS)
    assert all(np.isfinite(v).all() and len(v) == 1 for v in out.values())
    assert capsys.readouterr().out.count("losses=") == len(archs.ARCHS)


def test_example_serve_decode(capsys):
    from repro_torch.examples import serve_decode
    out = serve_decode.main(["--batch", "2", "--prompt-len", "4",
                             "--decode-steps", "3", "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    assert "request 0 tokens" in capsys.readouterr().out
