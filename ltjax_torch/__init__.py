"""ltjax_torch — the PyTorch + CUDA port of ltjax.

The JAX package ``ltjax`` stays the reference; this package mirrors its
module names so each counterpart is easy to find.  Plain functions act
on ``torch`` tensors, containers are ``@dataclass`` records of tensors,
and every tensor carries an explicit device.  The hot path (one whole
external step of RK4 advection + boundary reflection) is a CUDA kernel
written for Hopper (``ltjax_torch.kernels.ext_step``); on CPU tensors
the same functions run their plain PyTorch versions.

Nothing here imports ``jax`` or anything of ``ltjax``: the host modules
it needs (config, namelist, io.nc, io.roms) are the port's own copies.
"""

__version__ = "0.1.0"
