"""The benchmark of ``keras_nerf_tpu_torch``, the PyTorch / CUDA NeRF.

``python -m nerfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything a cell needs is found by name:

* ``configs/<config>.json``: the model and its published set-up;
* ``traffic/<traffic>.json``: the job's parameters, read by the driver
  ``traffic/<kind>.py`` that its ``kind`` names;
* ``workloads/<cell>.json``: what the cell's output check samples and the
  limit of each number it compares;
* ``layer_metrics/<metric>.py``: one reader a per-layer metric.

The yardstick lives here and nowhere else: the FLOP count (``flops.py``),
the scene and the inputs made from the seed (``scene.py``, ``inputs.py``),
the profiler's reduction (``trace.py``) and the plain float32 NeRF that
decides ``correct`` (``reference/``). From the program the benchmark takes
only the code under test; it never imports JAX or the JAX package.
"""
