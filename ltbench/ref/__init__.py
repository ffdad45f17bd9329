"""The plain reference of the benchmark: a frozen copy of the port's
plain PyTorch step (``ltjax_torch`` at the commit that added the
benchmark: the collapsed scheme's RK4, turbulence, behaviour,
reflection, settlement, mortality and sampling, with their grid,
interpolation, spline and random-stream code), with what no cell's
reference path reads taken out.  It imports nothing of the program, so
a change to the program cannot change what it is held against."""
