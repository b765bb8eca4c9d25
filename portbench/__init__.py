"""The benchmark of ``kubernetes_tpu_torch``, the PyTorch and CUDA port.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Nothing here imports JAX or the JAX package; the
reference that decides ``correct`` (``portbench/reference``) imports
nothing of the program either.
"""
