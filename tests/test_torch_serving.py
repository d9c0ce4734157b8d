"""The port's launcher, HTTP front door and load generator.

``repro_torch.launch.serve`` keeps the reference launcher's flags and
report: on the simulator (a verbatim copy) the two launchers print the
same text; on the engine backend (wall clock, so times differ) they print
the same lines with the same request counts.  The HTTP server on the
engine backend runs the port's torch engines on the CPU here."""
import io
import json
import os
import re
import socket
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import loadgen  # noqa: E402
from repro_torch.serving.http import ServerConfig, ServingServer  # noqa: E402


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("policy", ["dyna", "elastic"])
def test_sim_launcher_prints_what_the_jax_launcher_prints(policy):
    argv = ["--backend", "sim", "--duration", "5", "--policy", policy]
    got = _run(tserve.main, argv)
    assert got == _run(jserve.main, argv)
    assert got[0].startswith("== sim backend") and "completed=" in got[1]


def _shape(lines):
    """Each line with its numbers and runs of blanks collapsed, leaving
    out the kv-transfer line (whether a request split depends on the
    wall clock)."""
    return [re.sub(r"\s+", " ", re.sub(r"[-+]?\d+(\.\d+)?", "#", line))
            for line in lines if not line.startswith("kv-transfer")]


def _counts(lines):
    head = dict(kv.split("=") for kv in lines[1].split()[:4])
    rows = {line.split()[0]: line.split()[1:4] for line in lines
            if line.split()[0] in ("batch", "interactive", "standard")}
    return head, rows


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_engine_launcher_on_cpu_reports_like_the_jax_launcher(arch):
    """Paged KV (the paper's model) and the dense slot cache (the two
    recurrent models) behind the same launcher report."""
    argv = ["--smoke", "--arch", arch, "--requests", "4", "--prompt-len",
            "20", "--max-new", "6"]
    got = _run(tserve.main, argv + ["--device", "cpu"])
    exp = _run(jserve.main, argv)
    assert _shape(got) == _shape(exp)
    assert _counts(got) == _counts(exp)
    head, _ = _counts(got)
    assert head["offered"] == head["completed"] == "4"


def test_engine_launcher_refuses_sharded_widths(monkeypatch):
    """Sharded widths are no longer refused: on the CPU the launcher
    repeats the one CPU device for the shards (``REPRO_TORCH_DEVICE_COUNT``,
    as the reference forces the host platform's device count) and serves
    every request through TP=2 instances, with the width-1 run's report
    lines and counts.  A width the model cannot shard is still refused,
    with the reference's message."""
    from repro_torch.utils.device import DEVICE_COUNT_ENV
    monkeypatch.delenv(DEVICE_COUNT_ENV, raising=False)
    argv = ["--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-len", "20", "--max-new", "6"]
    one = _run(tserve.main, argv)
    two = _run(tserve.main, argv + ["--devices-per-instance", "2"])
    assert _shape(two) == _shape(one)
    assert _counts(two) == _counts(one)
    assert _counts(two)[0]["completed"] == "4"
    assert int(os.environ[DEVICE_COUNT_ENV]) >= 2
    with pytest.raises(ValueError, match="n_kv_heads=2 % 4 != 0"):
        tserve.main(argv + ["--devices-per-instance", "4"])


def test_engine_launcher_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--requests", "1"])


# ---------------------------------------------------------------------------
# HTTP on the engine backend, on the CPU
# ---------------------------------------------------------------------------
def _request(port, method, path, body=None, timeout=60.0):
    """One HTTP/1.1 exchange (the server closes every connection);
    returns (status, body bytes), chunked bodies de-chunked."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        payload = b"" if body is None else json.dumps(body).encode()
        head = f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
        if payload:
            head += f"Content-Length: {len(payload)}\r\n"
        s.sendall(head.encode() + b"\r\n" + payload)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    finally:
        s.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    if b"chunked" not in head.lower():
        return status, rest
    out = b""
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size or b"0", 16)
        if n == 0:
            break
        out, rest = out + rest[:n], rest[n + 2:]
    return status, out


def completed_requests(metrics_text: str) -> int:
    """Sum of ``dynaserve_requests_total{outcome="done"}`` over classes."""
    return int(sum(float(line.rsplit(" ", 1)[1])
                   for line in metrics_text.splitlines()
                   if line.startswith("dynaserve_requests_total{")
                   and 'outcome="done"' in line))


def test_engine_http_on_cpu_answers_unary_and_sse():
    srv = ServingServer(ServerConfig(
        port=0, backend="engine", device="cpu", arch="qwen3-moe-30b-a3b",
        engine_slots=4, engine_max_len=96, tick_events=4)).start()
    try:
        status, body = _request(srv.port, "POST", "/v1/completions",
                                {"prompt": list(range(1, 17)),
                                 "max_tokens": 5})
        assert status == 200
        out = json.loads(body)
        assert out["usage"]["completion_tokens"] == 5
        assert len(out["choices"][0]["text"].split()) == 5
        status, body = _request(srv.port, "POST", "/v1/chat/completions",
                                {"messages": [{"role": "user",
                                               "content": "hello"}],
                                 "max_tokens": 4, "stream": True})
        assert status == 200
        events = [line[len("data: "):] for line in body.decode().split("\n")
                  if line.startswith("data: ")]
        assert events[-1] == "[DONE]"
        pieces = [json.loads(e)["choices"][0]["delta"].get("content")
                  for e in events[:-1]]
        assert len([p for p in pieces if p]) == 4
        status, body = _request(srv.port, "GET", "/metrics")
        assert status == 200 and completed_requests(body.decode()) == 2
    finally:
        srv.stop()


def test_loadgen_smoke_self_serve():
    lines = _run(loadgen.main, ["--smoke", "--self-serve"])
    assert any(line.startswith("smoke OK:") for line in lines)
