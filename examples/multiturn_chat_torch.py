"""Multi-turn chat on the PyTorch port's engines with the shared-prefix
KV cache.

The port of ``examples/multiturn_chat.py``.  Drives ``session.generate``
over one conversation the way a chat client does: each turn's prompt is
the full history — previous prompts, the model's actual sampled replies,
and a new user message.  With ``prefix_cache=True`` the engine
recognizes the re-sent history, splices its cached pages, and prefills
only the new tokens; the per-turn stats show the saved prefill growing
with the conversation.  It runs on the CUDA card unless asked for the
CPU:

  PYTHONPATH=src python examples/multiturn_chat_torch.py
  PYTHONPATH=src python examples/multiturn_chat_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.core.session import ServeSession, SessionConfig  # noqa: E402
from repro_torch.engine.backend import EngineBackend        # noqa: E402
from repro_torch.models.model import init_params            # noqa: E402
from repro_torch.sim.policies import DynaServePolicy        # noqa: E402
from repro_torch.utils.device import resolve_device         # noqa: E402

TURNS = 4
USER_TOKENS = 24            # synthetic "user message" length
REPLY_TOKENS = 16


def main(argv=None, params=None):
    """Returns one ``{"prompt", "reply", "saved"}`` record a turn."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2.5-14b")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    backend = EngineBackend(cfg, params, n_slots=8, max_len=512,
                            page_size=8, prefix_cache=True)
    session = ServeSession(backend, DynaServePolicy(backend.cost),
                           SessionConfig(n_instances=2))

    rng = np.random.default_rng(0)
    history = rng.integers(0, cfg.vocab_size, USER_TOKENS).astype(np.int32)
    saved_before = 0
    turns = []
    for turn in range(TURNS):
        handle = session.generate(history, REPLY_TOKENS,
                                  rid=f"turn{turn}")
        reply = np.asarray(handle.result(), np.int32)
        saved = session.prefix_saved_tokens - saved_before
        saved_before = session.prefix_saved_tokens
        print(f"turn {turn}: prompt={len(history)} tok, "
              f"reply={len(reply)} tok, prefill skipped via cache="
              f"{saved} tok")
        turns.append({"prompt": len(history), "reply": reply.tolist(),
                      "saved": saved})
        # the client folds the model's reply + a new user message into
        # the next prompt — exactly the prefix the cache will hit
        user = rng.integers(0, cfg.vocab_size, USER_TOKENS).astype(np.int32)
        history = np.concatenate([history, reply, user])

    m = session.metrics()
    print(f"\nconversation done: hit_rate={m.prefix_hit_rate:.2f} "
          f"({m.prefix_hits}/{m.prefix_lookups} lookups), "
          f"saved_prefill={m.prefix_saved_tokens} tok, "
          f"saved_handoff={m.prefix_handoff_saved_tokens} tok, "
          f"computed_prefill={m.prefill_tokens_computed} tok")
    return turns


if __name__ == "__main__":
    main()
