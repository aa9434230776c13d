"""PyTorch/CUDA port of ``mpsnerf_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors ``mpsnerf_tpu`` so every function's counterpart
is easy to find.  This package imports ``torch``, numpy and scipy only:
it never imports jax, flax, cv2 or anything from ``mpsnerf_tpu``, so it
runs on a GPU host that has none of them.

Entry points take an explicit ``device`` (default ``"cuda"``).  The one
hand-written kernel of the serving path, the exact 1-NN
(``mpsnerf_torch/csrc/nearest_vertex.cu``), launches for CUDA tensors;
CPU tensors take its plain PyTorch version (``ops/knn.py``).
"""
