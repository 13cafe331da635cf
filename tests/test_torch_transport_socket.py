"""``fed_train --transport socket`` on the port: real worker subprocesses
over local TCP on the CPU, held to the port's in-process CLI and to the
JAX package's CLI on the same flags; the CLI's transport flags, banner
and refusals against the reference's.

The JAX CLI runs the loopback transport here (one process: its socket
run's metrics are its in-process run's, pinned by the reference's own
tests/test_transport.py, and its frames are the loopback's bytes)."""
import re

import numpy as np
import pytest

from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.launch import fed_train as jfed_train
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

FLAGS = ["--clients", "6", "--rounds", "2", "--clauses", "16",
         "--local-epochs", "1"]
TOTALS = ("upload_bytes", "download_bytes_broadcast",
          "download_bytes_per_client")


def _round_lines(text: str, wire: bool = True) -> list[str]:
    """The round and totals lines without the mean accuracy (and, with
    ``wire=False``, without the wire gauges)."""
    out = []
    for line in text.splitlines():
        if line.startswith(("round ", "totals:")):
            line = re.sub(r" acc=\S+", "", line)
            if not wire:
                line = re.sub(r" wire_(tx|rx)=\S+", "", line)
            out.append(line)
    return out


@pytest.fixture(autouse=True, scope="module")
def one_thread_workers():
    """Worker subprocesses inherit the environment: one intra-op thread
    each, as the test process runs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def cli_runs():
    """The port's CLI in process, over loopback and over sockets (two
    worker processes), and the JAX CLI over loopback, on the same
    flags."""
    out = {}
    for name, extra in (("inprocess", []),
                        ("loopback", ["--transport", "loopback",
                                      "--workers", "2"]),
                        ("socket", ["--transport", "socket",
                                    "--workers", "2"])):
        out[name] = _capture(lambda: fed_train.main(
            ["--device", "cpu", *FLAGS, *extra]))
    out["jax_loopback"] = _capture(lambda: jfed_train.main(
        [*FLAGS, "--transport", "loopback", "--workers", "2"]))
    return out


def _capture(fn):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue()


def test_socket_cli_equals_the_in_process_cli(cli_runs):
    (ref, ref_text), (out, text) = cli_runs["inprocess"], cli_runs["socket"]
    assert out["acc_per_round"] == ref["acc_per_round"]
    for k in TOTALS:
        assert out[k] == ref[k], k
    assert out["final_accuracy_deciles"] == ref["final_accuracy_deciles"]
    assert _round_lines(text, wire=False) == _round_lines(ref_text)
    assert out["state"] is None          # the rows lived in the workers
    assert "backend=socket transport, 2 worker processes" in text


def test_socket_cli_equals_the_jax_cli(cli_runs):
    """Metrics, totals and the round lines with their wire gauges: the
    socket run put the JAX package's bytes on the wire."""
    (ref, ref_text), (out, text) = (cli_runs["jax_loopback"],
                                    cli_runs["socket"])
    np.testing.assert_allclose(out["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)
    for k in TOTALS:
        assert out[k] == ref[k], k
    assert _round_lines(text) == _round_lines(ref_text)
    assert all("wire_tx=" in line for line in _round_lines(text)[:-1])


def test_loopback_cli_equals_the_jax_cli(cli_runs):
    (ref, ref_text), (out, text) = (cli_runs["jax_loopback"],
                                    cli_runs["loopback"])
    assert _round_lines(text) == _round_lines(ref_text)
    assert "backend=loopback transport, 2 worker peers" in text
    assert "backend=loopback transport, 2 worker peers" in ref_text
    sock = cli_runs["socket"][0]
    assert out["acc_per_round"] == sock["acc_per_round"]
    for rep_l, rep_s in zip(out["reports"], sock["reports"]):
        assert (rep_l.wire_tx_bytes, rep_l.wire_rx_bytes) == \
            (rep_s.wire_tx_bytes, rep_s.wire_rx_bytes)


REFUSALS = {
    "resume": (["--transport", "loopback", "--workers", "2", "--resume",
                "--ckpt-dir", "unused"], SystemExit),
    "mmap_store": (["--transport", "socket", "--workers", "2",
                    "--client-store", "mmap"], ValueError),
    "n_clients": (["--transport", "loopback", "--workers", "2",
                   "--dataset", "synthfemnist", "--data-dir", "DATA",
                   "--n-clients", "8", "--client-store", "mmap"],
                  ValueError),
    "no_workers": (["--transport", "loopback"], ValueError),
    "workers_in_process": (["--workers", "2"], ValueError),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_cli_refusals_match_the_reference(case, tmp_path):
    """Each refusal of a transport run raises what the reference's CLI
    raises, with its message; the port refuses before it draws or
    writes any data.  (A streamed population needs the mmap store, which
    the reference's ``RuntimeConfig`` refuses under a transport after
    its CLI has written the LEAF mirror: that message is taken from
    ``RuntimeConfig`` directly.)"""
    flags, err = REFUSALS[case]
    flags = [str(tmp_path) if f == "DATA" else f for f in flags]
    base = ["--clients", "2", "--clauses", "8", "--rounds", "1"]
    with pytest.raises(err) as ours:
        fed_train.main(["--device", "cpu", *base, *flags])
    assert not any(tmp_path.iterdir())     # refused before any data
    with pytest.raises(err) as theirs:
        if case == "n_clients":
            JRuntimeConfig(transport="loopback", workers=2,
                           client_store="mmap")
        else:
            jfed_train.main([*base, *flags])
    assert str(ours.value) == str(theirs.value)


def test_socket_worker_reports_its_device_at_shutdown(capfd):
    """Each socket worker writes one ``transport worker`` line to stderr
    at SHUTDOWN: rank, device, kernel launches, peak device memory (the
    launch counters are per process)."""
    import json
    fed_train.main(["--device", "cpu", "--clients", "4", "--rounds", "1",
                    "--clauses", "8", "--local-epochs", "1",
                    "--transport", "socket", "--workers", "2"])
    err = capfd.readouterr().err
    lines = [json.loads(line.split("transport worker ", 1)[1])
             for line in err.splitlines()
             if line.startswith("transport worker ")]
    assert sorted(w["rank"] for w in lines) == [0, 1]
    for w in lines:
        assert w["device"] == "cpu" and w["peak_bytes"] == 0
        assert set(w["launches"]) >= {"train_epoch_fused",
                                      "fused_votes_batched"}
