"""The benchmark of ltjax_torch, the PyTorch and CUDA port of ltjax, on
one NVIDIA H100: ``python3 -m ltbench --workload NAME --seed N --seconds
S --trace 0|1`` (``ltbench.run``).  Everything a cell needs is data
under this folder (``configs/``, ``traffic/``, ``limits/``, ``metrics/``)
found by the names in ``BENCHMARK.json``; the yardstick (inputs, the
plain reference ``ltbench.ref``, the work count, the peaks) imports
nothing of the program."""
