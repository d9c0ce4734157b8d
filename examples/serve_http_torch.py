"""The PyTorch port's HTTP front door, end to end in one process: boot an
in-process ``ServingServer`` (sim backend, ephemeral port), talk to it
with plain ``urllib`` + a raw socket for SSE, then read back the
Prometheus metrics and the request's trace spans.

The port of ``examples/serve_http.py``.  The engine backend runs the
port's engines on the CUDA card unless asked for the CPU:

  PYTHONPATH=src python examples/serve_http_torch.py [--backend engine]
  PYTHONPATH=src python examples/serve_http_torch.py --backend engine --device cpu

Against a standalone server (``python -m repro_torch.launch.serve --http``)
the same requests work from curl:

  curl localhost:8000/v1/completions -d '{"prompt": "hello", "max_tokens": 8}'
  curl -N localhost:8000/v1/completions \\
       -d '{"prompt": "hello", "max_tokens": 8, "stream": true, "slo": "interactive"}'
"""
import argparse
import json
import os
import socket
import sys
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.serving.http import ServerConfig, ServingServer


def post_json(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def stream_sse(port, path, obj):
    """Raw-socket SSE client: yields each data event as it arrives."""
    payload = json.dumps(obj).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(f"POST {path} HTTP/1.1\r\nHost: localhost\r\n"
              f"Content-Type: application/json\r\n"
              f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    _head, buf = buf.split(b"\r\n\r\n", 1)
    while True:                      # chunked body -> SSE events
        data = s.recv(4096)
        if not data:
            break
        buf += data
        while b"\n\n" in buf:
            event, _, buf = buf.partition(b"\n\n")
            for line in event.splitlines():
                if line.startswith(b"data: "):
                    yield line[6:].decode()
    s.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["sim", "engine"], default="sim")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine backend; 'cpu' runs "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)

    server = ServingServer(ServerConfig(port=0, backend=args.backend,
                                        admission=True,
                                        device=args.device)).start()
    port = server.port
    print(f"== in-process {args.backend} server on port {port} ==\n")

    # 1. unary completion
    out, headers = post_json(port, "/v1/completions",
                             {"prompt": "the quick brown fox",
                              "max_tokens": 8})
    print("unary completion:", out["choices"][0]["text"].strip())
    print("  usage:", out["usage"], " trace:", headers.get("x-trace-id"))

    # 2. streamed chat completion with an SLO class
    print("\nstreamed chat (interactive class): ", end="", flush=True)
    for data in stream_sse(port, "/v1/chat/completions",
                           {"messages": [{"role": "user",
                                          "content": "say something"}],
                            "max_tokens": 6, "stream": True,
                            "slo": "interactive"}):
        if data == "[DONE]":
            break
        delta = json.loads(data)["choices"][0]["delta"]
        print(delta.get("content", ""), end="", flush=True)
    print()

    # 3. metrics + trace spans
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
        text = r.read().decode()
    wanted = ("dynaserve_requests_total", "dynaserve_ttft_seconds_count",
              "dynaserve_queue_depth")
    print("\nmetrics sample:")
    for line in text.splitlines():
        if line.startswith(wanted):
            print(" ", line)
    trace = server.tracer.finished[-1]
    print(f"\ntrace {trace['trace_id']} ({trace['outcome']}, "
          f"{trace['n_tokens']} tokens):")
    for span in trace["spans"]:
        print(f"  {span['name']:<10} {span['dur']*1e3:8.2f} ms")

    server.stop()
    print("\nclean shutdown")


if __name__ == "__main__":
    main()
