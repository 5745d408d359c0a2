"""Command-line drivers of the port, each the counterpart of the JAX
package's script of the same name under drivers/, with the same positional
arguments and defaults:

    python -m ttcross_tpu_torch.drivers.<name> ARGS

The f64 cross: crs_ising (Ising C / D / E), crs_stdnorm (the product
Gaussian), crs_mvn (the MVN mass), crs_mvn_complex (its complex
contraction), crs_chf (the basket CHF; TTCROSS_MESH=N under torchrun
contracts over N ranks), crs_pdf (the basket density, out/tt-cross-pdf.txt),
crs_store (the train saved as HDF5 and .ttx), crs_coscoeff (the COS
coefficient tensor), crs_batch (a correlation family in one cross_batch),
crs_greeks (the frozen skeleton's gradient and vmapped sweep),
crs_quantics (a 2^K quantics grid); the COS tables: print_s_vectors,
print_cos_coeff; the precision tiers: crs_ising_dd (the dd
defect-corrected cross), crs_ising_mp (the dd engine), crs_stdnorm_dd (an
f64 cross refined in dd), crs_ising_qd (the qd defect pipeline),
crs_ising_qde (the qd engine, WORKERS > 1 over spawned workers) and
chf_equal (the CHF against its C++ twin).  These run on the card unless
main(argv, device="cpu") asks for the CPU.  crs_ising_mpf (the mpmath
engine), crs_ising_mpn (the compiled MPFR engine) and plot_ttcross_data
(matplotlib) are host code and take no device.  Each module's main(argv=
None, ...) takes the arguments after the program's name (sys.argv[1:] when
None) and returns the exit code; plot_ttcross_data's entry is
plot_pdf(path, out, svd_path)."""

DRIVERS = ("crs_ising", "crs_stdnorm", "crs_mvn", "crs_mvn_complex", "crs_chf", "crs_pdf",
           "crs_store", "crs_coscoeff", "crs_batch", "crs_greeks", "crs_quantics",
           "print_s_vectors", "print_cos_coeff", "plot_ttcross_data",
           "crs_ising_dd", "crs_ising_mp", "crs_stdnorm_dd", "crs_ising_qd", "crs_ising_qde",
           "crs_ising_mpf", "crs_ising_mpn", "chf_equal")

__all__ = ["DRIVERS"]
