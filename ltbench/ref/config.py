"""Run configuration — mirrors the reference's parameter set (a frozen
copy of ``ltjax_torch.config.Config``, without the namelist reader).

The port's own copy of ``ltjax.config`` (the same fields, defaults,
``needs_salt_fields`` and ``validate``), so ``ltjax_torch`` never imports
the JAX package.  The reference declares ~80 module-level run parameters
in ``parameter_module.f90`` (param_mod [conf: H]) populated by
``getParams`` from the Fortran namelist file ``LTRANS.data`` (SURVEY.md
SS5.6).  We keep **the same parameter names** in a dataclass so the
original run files load unmodified through :mod:`ltjax_torch.namelist`,
and add a handful of build-only knobs (dtypes, sharding, prefetch) in a
separate section; those of the TPU kernels are read by ltjax alone.
"""

from __future__ import annotations

from dataclasses import dataclass



@dataclass
class Config:
    # --- numparticles ---------------------------------------------------
    numpar: int = 1000            # number of particles

    # --- timeparam ------------------------------------------------------
    days: float = 1.0             # run duration [days]
    iprint: int = 3600            # output interval [s]
    dt: int = 3600                # external step = hydro record spacing [s]
    idt: int = 120                # internal (advection) step [s]

    # --- hydroparam -----------------------------------------------------
    us: int = 20                  # number of rho s-levels
    ws: int = 21                  # number of w s-levels (us+1)
    tdim: int = 24                # time records per history file
    hc: float = 0.2               # s-coordinate critical depth [m]
    z0: float = 0.0005            # bottom roughness height [m]
    Vtransform: int = 1           # ROMS vertical transform (1 or 2)
    readZeta: bool = True
    constZeta: float = 0.0
    readSalt: bool = False
    constSalt: float = 0.0
    readTemp: bool = False
    constTemp: float = 0.0
    readDens: bool = False
    constDens: float = 1025.0
    readU: bool = True
    constU: float = 0.0
    readV: bool = True
    constV: float = 0.0
    readW: bool = True
    constW: float = 0.0
    readAks: bool = True
    constAks: float = 0.0

    # --- turbparam ------------------------------------------------------
    HTurbOn: bool = False
    VTurbOn: bool = False
    ConstantHTurb: float = 1.0    # horizontal diffusivity [m^2/s]
    ConstantVTurb: float = 0.0    # vertical diffusivity if not from Aks

    # --- behavparam -----------------------------------------------------
    Behavior: int = 0             # behavior type 0..7 (SURVEY.md SS2.1 #8)
    OpenOceanBoundary: bool = True
    mortality: bool = False
    deadage: float = 1e30         # age of death [s]
    stochastic_mortality: bool = False  # random death (constant hazard
                                  #   1/deadage; expected lifetime =
                                  #   deadage) instead of deterministic
                                  #   death exactly AT deadage.
                                  #   SURVEY.md SS2.1 #8 [conf: M]
                                  #   reads the reference's mortality
                                  #   as random; both readings are
                                  #   selectable pending mount-return
                                  #   verification (CONSTANTS.md)
    pediage: float = 0.0          # age competent to settle [s]
    swimstart: float = 0.0        # age swimming begins [s]
    swimslow: float = 0.0         # initial swim speed [m/s]
    swimfast: float = 0.0         # final swim speed [m/s]
    Sgradient: float = 1.0        # salinity-gradient cue [psu/m]
    sink: float = 0.0             # sinking velocity (type 6) [m/s]
    Hswimspeed: float = 0.0       # horizontal swim speed (type 7) [m/s]
    Swimdepth: float = 2.0        # swim depth for TST (type 7) [m]

    # --- dvmparam (type 3) ----------------------------------------------
    twistart: float = 4.801821    # time of twilight start [h]
    twiend: float = 19.19956      # time of twilight end [h]
    Em: float = 1935.077          # max. surface irradiance
    Kp: float = 0.4               # light attenuation coefficient [1/m]
    thresh: float = 0.0166        # irradiance threshold

    # --- settleparam ----------------------------------------------------
    settlementon: bool = False
    holesExist: bool = False
    minpolyid: int = 101
    maxpolyid: int = 101
    minholeid: int = 0
    maxholeid: int = 0
    pedges: int = 0               # number of habitat polygon edge rows
    hedges: int = 0               # number of hole polygon edge rows

    # --- convparam ------------------------------------------------------
    PI: float = 3.14159265358979323846
    Earth_Radius: float = 6378e3  # [m]
    SphericalProjection: bool = True
    latmin: float = 0.0           # reference latitude for projection
    lonmin: float = 0.0           # reference longitude for projection

    # --- romsgrid / romsoutput ------------------------------------------
    NCgridfile: str = ""
    dirin: str = ""
    prefix: str = ""
    suffix: str = ".nc"
    filenum: int = 1              # first history-file number
    numdigits: int = 4            # zero padding of file number
    startfile: bool = True        # begin at record 1 of first file

    # --- parloc / habpolyloc --------------------------------------------
    parfile: str = ""             # initial particle CSV
    habitatfile: str = ""         # settlement polygon CSV
    holefile: str = ""            # settlement hole-polygon CSV

    # --- output ---------------------------------------------------------
    outpath: str = "."
    NCOutFile: str = "ltjax_out"
    outpathGiven: bool = True
    writeCSV: bool = False
    writeNC: bool = True
    RunName: str = "ltjax run"
    ExeDir: str = "."
    OutDir: str = "."
    RunBy: str = ""
    Institution: str = ""
    StartedOn: str = ""

    # --- other ----------------------------------------------------------
    seed: int = 9                 # RNG seed
    ErrorFlag: int = 0            # 0 halt on particle error; 1/2/3 flag+continue
    SaltTempOn: bool = False
    TrackCollisions: bool = False
    WriteHeaders: bool = False
    WriteModelTiming: bool = False
    WriteParfile: bool = False
    BoundaryBLNs: bool = False

    # --- knobs with no reference analog ---------------------------------
    dtype_pos: str = "float64"    # particle position dtype (float64, or
                                  #   float32: the GPU kernels' faster builds)
    dtype_field: str = "float32"  # field gather/interpolation dtype
    tension_sigma: float = 0.0    # uniform dimensionless spline tension;
                                  #   <0 => adaptive (SIGS-like) selection
    fast_interp: bool = True      # time-collapse-first interpolation
                                  #   (packed records, stage tables);
                                  #   False => the native route, the
                                  #   reference's order (step.mode_flags)
    kernel_interp: bool = True    # True: the CUDA kernels wherever one
                                  #   exists (K1, or K2 for stochastic
                                  #   mortality: the collapsed scheme,
                                  #   blend-then-fit, on every grid and
                                  #   position dtype); False: the packed
                                  #   route, ltjax's packed scheme (per-
                                  #   column fits, eval-then-blend) as
                                  #   PyTorch ops, which ltjax runs
                                  #   wherever its TPU kernel does not
    kernel_block: int = 0         # TPU only (Pallas particle block):
                                  #   read from the run file, ignored by
                                  #   the port (K1's block is 128)
    kernel_precision: str = "pair2"  # TPU only (MXU one-hot blend
                                  #   precision): read, ignored; the
                                  #   port blends 4 corners in f32/f64
    kernel_wy: int = 16           # TPU only (VMEM window cells, eta):
                                  #   read, ignored (the port stages a
                                  #   box per block, ext_step.block_boxes)
    kernel_wx: int = 8            # TPU only (VMEM window cells, xi):
                                  #   read, ignored; the port's Hilbert
                                  #   key takes no aspect from them
    kernel_fast_math: bool = True # TPU only (approx-reciprocal divides):
                                  #   read, ignored (exact divides)
    kernel_sfast: bool = True     # TPU only (the constant-ladder spline
                                  #   of the fused kernels): read,
                                  #   ignored (the port's kernels fit on
                                  #   each particle's z-space knots)
    ext_fuse: int = 8             # external steps fused per compiled
                                  #   call on the megakernel path (the
                                  #   field window holds ext_fuse + 2
                                  #   records); 1 = classic triple
                                  #   buffer.  8 amortizes the ~26 ms
                                  #   per-call dispatch to ~3 ms/ext
                                  #   (output/checkpoint cadence still
                                  #   clamps the chunk in run.py)
    ext_sort_every: int = 2       # Hilbert re-sort cadence inside a
                                  #   fused call [external steps].  The
                                  #   row-packed sort costs ~15 ms at 1M;
                                  #   blocks stay coherent over several
                                  #   steps (bulk drift is tracked by the
                                  #   kernel's window origins; turbulence
                                  #   spreads a block < 0.1 cell per ext
                                  #   step), so every-2 measures the same
                                  #   window-miss rate as every-1 on the
                                  #   bench flow.  Strongly sheared flows
                                  #   can set 1; misses are never silent
                                  #   (exact patch -> ERROR on overflow)
    sort_depth_bands: int = 1     # >1: band the Hilbert sort by height
                                  #   above the seabed (band-major key,
                                  #   bands of sort_band_height metres,
                                  #   top band open-ended; 1 = off, max
                                  #   6).  Reorders the batch only: a
                                  #   banded run equals an unbanded one
                                  #   bit for bit.  On the H100 it lets
                                  #   more blocks stage their corners
                                  #   where each band stays dense under
                                  #   a persistent vertical shear (4M
                                  #   particles, 280 a cell: K1 -12%),
                                  #   and costs where it thins them
                                  #   (1M: up to +8%; turbulence:
                                  #   +18%), PERF.md
    sort_band_height: float = 4.0 # metres above bottom per sort band
    sort_band_log: bool = False   # log2-spaced bands instead of equal
                                  #   slabs: boundaries at
                                  #   sort_band_height * 2^k metres
                                  #   (k = 0..n-2; lowest band below
                                  #   sort_band_height).  The bottom
                                  #   log layer's horizontal speed goes
                                  #   as ln(height above bed), so
                                  #   equal-log-height bands are
                                  #   equal-speed bands — the right
                                  #   split once particles LIVE inside
                                  #   the layer (equal slabs only help
                                  #   during the approach)
    oob_frac: int = 0             # TPU only (capacity of the exact
                                  #   out-of-window patch): read from
                                  #   the run file, ignored (the port's
                                  #   kernels have no window to miss)
    reflect_iters: int = 4        # fixed boundary-reflection iteration count
    mesh_particles: int = 1       # mesh axis size: particle data-parallel
    mesh_tiles: int = 1           # mesh axis size: domain tiles (eta strips)
    migrate_capacity: float = 1.5 # per-tile particle buffer slack factor
    halo_rows: int = 4            # halo rows per tile side (must cover
                                  #   max displacement per external step
                                  #   + 1 stencil row; shard.halo_rows_needed)
    prefetch: bool = True         # async host->device field prefetch
    checkpoint_every: int = 0     # external steps between checkpoints (0=off)
    checkpoint_dir: str = "ckpt"

    # ---------------------------------------------------------------------
    def needs_salt_fields(self) -> bool:
        """Salt (and temp) fields/lanes are needed when sampling is on
        OR a salinity-cued behavior (4/5) runs — the round-4 code keyed
        everything on SaltTempOn alone, which crashed the megakernel at
        trace time for Behavior 4/5 with SaltTempOn off and silently
        zeroed the halocline cue on the XLA path."""
        return self.SaltTempOn or self.Behavior in (4, 5)

    @property
    def external_steps(self) -> int:
        return int(round(self.days * 86400.0 / self.dt))

    @property
    def internal_steps(self) -> int:
        assert self.dt % self.idt == 0, "dt must be a multiple of idt"
        return self.dt // self.idt

    @property
    def output_every_ext(self) -> int:
        """External steps between outputs."""
        return max(1, self.iprint // self.dt)

    def validate(self) -> None:
        if self.dt % self.idt != 0:
            raise ValueError(f"dt={self.dt} not a multiple of idt={self.idt}")
        if self.Vtransform not in (1, 2):
            raise ValueError(f"Vtransform must be 1 or 2, got {self.Vtransform}")
        if not 0 <= self.Behavior <= 7:
            raise ValueError(f"Behavior must be in 0..7, got {self.Behavior}")
        if self.ws != self.us + 1:
            raise ValueError(f"ws ({self.ws}) must equal us+1 ({self.us + 1})")
        if self.Behavior in (4, 5) and not self.readSalt:
            # oyster-larva ontogenetic migration (types 4/5) cues on the
            # vertical salinity gradient (behavior_module.f90, SURVEY.md
            # SS2.1 #8); without salt fields the cue is silently zero.
            # (SaltTempOn is NOT required: needs_salt_fields() packs the
            # salt lanes for the cue regardless of output sampling —
            # the round-4 coupling crashed the megakernel at trace time
            # for Behavior 4/5 with SaltTempOn off.)
            raise ValueError(
                f"Behavior={self.Behavior} (salinity-cued ontogenetic "
                "migration) requires readSalt — without salt fields "
                "the dS/dz cue is identically zero")
