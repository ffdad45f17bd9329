"""The benchmark of ltjax_torch, the PyTorch and CUDA port of ltjax, on
NVIDIA H100s: ``python3 -m ltbench --workload NAME --seed N --seconds
S --trace 0|1`` (``ltbench.run``; a cell on several cards runs one rank
a card, ``ltbench.sharded``).  Everything a cell needs is data
under this folder (``configs/``, ``traffic/``, ``limits/``, ``metrics/``)
found by the names in ``BENCHMARK.json``; the yardstick (inputs, the
plain reference ``ltbench.ref``, the work count, the peaks) imports
nothing of the program."""
