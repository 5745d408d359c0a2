"""Command-line drivers of the port's precision tiers, each the counterpart
of the JAX package's script of the same name under drivers/, with the same
positional arguments and defaults:

    python -m ttcross_tpu_torch.drivers.<name> ARGS

crs_ising_dd (the dd defect-corrected cross), crs_ising_mp (the dd engine),
crs_stdnorm_dd (an f64 cross refined in dd), crs_ising_qd (the qd defect
pipeline), crs_ising_qde (the qd engine, WORKERS > 1 over spawned workers)
and chf_equal (the CHF against its C++ twin) run on the card unless
main(argv, device="cpu") asks for the CPU; crs_ising_mpf (the mpmath
engine) and crs_ising_mpn (the compiled MPFR engine) are host code, as the
mp tier is.  Each module's main(argv=None, ...) takes the arguments after
the program's name (sys.argv[1:] when None) and returns the exit code."""

DRIVERS = ("crs_ising_dd", "crs_ising_mp", "crs_stdnorm_dd", "crs_ising_qd", "crs_ising_qde",
           "crs_ising_mpf", "crs_ising_mpn", "chf_equal")

__all__ = ["DRIVERS"]
