"""DynaServe on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` module for module, so each counterpart is
found under the same path.  The framework-free layers (``core``,
``sim``, ``data``, ``configs``, the page allocator and prefix cache, and
``serving`` but for the engine branch of ``serving.http.make_session``)
are verbatim copies of the reference with the import prefix rewritten;
the model, kernels, engine and launcher are ported to torch, and the two
attention kernels are hand-written CUDA for Hopper (``csrc/``).

Entry points place tensors on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""
