"""Analytic values: the Ising susceptibility integrals C_m / D_m / E_m, the
product-Gaussian integral, the MVN mass, and the basket characteristic
function's golden tables.

The constants are Bailey, Borwein & Crandall's public tables, as in
ttcross_tpu/apps/truths.py, cut to 70 significant digits: the f64 tiers
take them as float64 (70 digits round to the same double as the 500-digit
strings), and the dd tier measures its ~32 digits against the strings
(ISING_C_STR, TPI_STR) with decimal at 60 digits.  The
characteristic-function tables are the port's own copy of
ttcross_tpu/apps/truths.py:316-407.
"""

from __future__ import annotations

__all__ = ["ising_truth", "ising_truth_str", "ISING_C_STR", "ISING_DE_STR", "TPI_STR", "STDNORM",
           "MVN_MASS", "CHF_REFERENCE", "CHF_RHO05"]

TPI_STR = "6.283185307179586476925286766559005768394338798750211641949889184615632"
TPI = float(TPI_STR)
LOG2 = float("0.6931471805599453094172321214581765680755001343602552541206800094933936")
ZETA3 = float("1.202056903159594285399738161511449990764986292340498881792271555341838")

ISING_C_STR = {
    2: "1",
    3: "0.781302412896486296867187429624092356365134336545285420222100062966886",
    4: "0.701199860176429999816513927548345827946242003865291014378825073949405",
    5: "0.665759800199937428315733808307066598197496382079497659539442703531227",
    6: "0.648634209031007075263149843450351690889772509481627995615050887184781",
    8: "0.635484026759163226139684899936898393485446063736278309835724508002389",
    16: "0.630503946173237263505295657560687419484316217208103047750879119737058",
    32: "0.630473504207339806379189843197962510193081141118420178126828333519119",
    64: "0.630473503374386796488362088165338625359988808600159169054746716997441",
    128: "0.630473503374386796122040192710878904393135639979012750412245536553653",
    256: "0.630473503374386796122040192710878904354587078712732341573817983708970",
    512: "0.630473503374386796122040192710878904354587078712732341573817983708970",
    1024: "0.630473503374386796122040192710878904354587078712732341573817983708970",
}
ISING_C = {m: float(v) for m, v in ISING_C_STR.items()}

ISING_DE_STR = {
    ("D", 5): "0.00248460576234031547995050915390974963506067764248751615870769216182",
    ("D", 6): "0.00048914170018803477510066231535045603322055262753059988378760460832",
    ("E", 5): "0.00349365371172952174068806727918425156963294495514131468369898233699",
    ("E", 6): "0.00068783287182640943700478427369021070381480331032227271753389653967",
}
ISING_DE = {k: float(v) for k, v in ISING_DE_STR.items()}


def ising_truth(kind: str, m: int) -> float:
    """Analytic value of C_m, D_m or E_m (KeyError if not tabulated)."""
    kind = kind.upper()
    if kind == "C":
        return ISING_C[m]
    if kind == "D":
        if m == 2:
            return 1.0 / 3.0
        if m == 3:
            return 8.0 + TPI**2 / 3.0 - 27.0 * ISING_C[3]
        if m == 4:
            return TPI**2 / 9.0 - 1.0 / 6.0 - 7.0 * ZETA3 / 2.0
        return ISING_DE[("D", m)]
    if kind == "E":
        if m == 2:
            return 6.0 - 8.0 * LOG2
        if m == 3:
            return 10.0 - TPI**2 / 2.0 - 8.0 * LOG2 + 32.0 * LOG2**2
        if m == 4:
            return (22.0 - 82.0 * ZETA3 - 24.0 * LOG2 + 176.0 * LOG2**2
                    - 256.0 * LOG2**3 / 3.0 + 4.0 * TPI**2 * LOG2 - 11.0 * TPI**2 / 6.0)
        return ISING_DE[("E", m)]
    raise KeyError(f"unknown Ising integral kind: {kind}")


def ising_truth_str(kind: str, m: int) -> str:
    """The decimal string of a tabulated C_m, D_m or E_m (the qd tier
    counts its digits against it); KeyError when it is not tabulated (the
    JAX package's mpmath fallback for the small D / E closed forms belongs
    to the mp tier)."""
    kind = kind.upper()
    if kind == "C":
        return ISING_C_STR[m]
    return ISING_DE_STR[(kind, m)]


def STDNORM(d: int) -> float:
    """Truth for the product-Gaussian integral: pi^(d/2)
    (test_crs_stdnorm.f90:83)."""
    import math

    return math.pi ** (d / 2)


MVN_MASS = 1.0  # the MVN pdf integrates to 1 (test_crs_mvn.f90:83)

# 32 reference characteristic-function values of the 6-d lognormal basket
# (test_crs_chf.f90:232-271).  They are stale relative to the reference's
# current source: at its own parameters (rho = 0.5, mvn_pdf.f90:19) a
# converged cross deviates from them by 2.4e-2, and the best-matching
# equicorrelation is rho ~ 0.552 (max deviation 1.5e-4).  CHF_RHO05 below
# is the tight target.
CHF_REFERENCE = [
    complex(1.0000000000000004, 0.0),
    complex(0.477573486783962, 0.8149466884621303),
    complex(-0.36837299289083225, 0.7151922711168992),
    complex(-0.6257714195536066, 0.09178553732163314),
    complex(-0.34684735452966187, -0.3172332243460625),
    complex(-0.0017955158585152564, -0.33646866663071234),
    complex(0.162377557153463, -0.17003135351832718),
    complex(0.16111757391061166, -0.014897840710532378),
    complex(0.09249068083644305, 0.06033659639176453),
    complex(0.026622324264449382, 0.07016730893534587),
    complex(-0.011662817341915883, 0.04952550109973056),
    complex(-0.02453611388348422, 0.024273967930164675),
    complex(-0.02283078002233625, 0.005817209101882007),
    complex(-0.015560865654613152, -0.004063037376331763),
    complex(-0.008092447372180414, -0.007401121012863568),
    complex(-0.0026887989524065486, -0.007093450692951045),
    complex(0.00035180694746948793, -0.005222442957982434),
    complex(0.001702458119621754, -0.0031713885853042268),
    complex(0.0019787600882656027, -0.0016294446166633578),
    complex(0.0017002968172530539, -0.0004927083206423032),
    complex(0.0012683915479485622, 0.00011351837686527592),
    complex(0.0008009851216763085, 0.0004300613182277521),
    complex(0.0004241540880317125, 0.0004423028147576922),
    complex(0.00017861244723283787, 0.0004195598508893528),
    complex(2.8445454564976957e-05, 0.00031333373400801133),
    complex(-4.530757450752984e-05, 0.00022356345058376992),
    complex(-8.234702200071308e-05, 0.00016196042183622313),
    complex(-9.948295545041033e-05, 8.23964841318507e-05),
    complex(-8.455184484541963e-05, 4.940045542157806e-05),
    complex(-6.974592247472916e-05, 1.6767171278621708e-05),
    complex(-5.3515566669730744e-05, -1.2023150233163912e-05),
    complex(-3.397596073667283e-05, -2.6028176412912153e-05),
]

# Goldens regenerated at the reference's current source parameters
# (mvn_pdf.f90:15-60: sigma = 0.4, corr = 0.5, T = 1, r = 0, X0 = log 100;
# box [0.52517, 8.52517]; 65-node Gauss-Legendre per mode; omega_k =
# k pi / 300, basket = mean of exp(x_j), d = 6) by a rank-32 TT-cross
# (accuracy 500 eps, rook pivoting): stable to 2.5e-10 across lottery keys
# and rank-converged to 1.0e-7 against rank 24; phi_0 = 1 + 2.6e-11.
CHF_RHO05 = [
    complex(+1.000000000026e+00, +0.000000000000e+00),
    complex(+4.787288762027e-01, +8.185699805200e-01),
    complex(-3.778841102939e-01, +7.227842048097e-01),
    complex(-6.436153293730e-01, +8.322091339510e-02),
    complex(-3.490424635050e-01, -3.409436652071e-01),
    complex(+1.648926835623e-02, -3.523342458621e-01),
    complex(+1.842336038788e-01, -1.665367000407e-01),
    complex(+1.718842448755e-01, +6.813494369036e-04),
    complex(+9.019151744050e-02, +7.562402197678e-02),
    complex(+1.746033364799e-02, +7.817877396486e-02),
    complex(-2.102928525862e-02, +5.012688705354e-02),
    complex(-3.064757481848e-02, +2.048854258017e-02),
    complex(-2.501161588095e-02, +8.617649537604e-04),
    complex(-1.499265633672e-02, -8.069519438216e-03),
    complex(-6.299158758284e-03, -9.762523310703e-03),
    complex(-7.235026149379e-04, -7.923535594534e-03),
    complex(+1.981974711456e-03, -5.098874690893e-03),
    complex(+2.746313484730e-03, -2.593482365052e-03),
    complex(+2.477989928961e-03, -8.503236084823e-04),
    complex(+1.819457668013e-03, +1.457057897454e-04),
    complex(+1.135669818030e-03, +5.851726845890e-04),
    complex(+5.873975903840e-04, +6.796774579286e-04),
    complex(+2.134260082671e-04, +5.976039800580e-04),
    complex(-6.693227849033e-06, +4.502470375952e-04),
    complex(-1.135820765358e-04, +3.002020853937e-04),
    complex(-1.477231325645e-04, +1.760279944712e-04),
    complex(-1.412291361607e-04, +8.578417987835e-05),
    complex(-1.162302026989e-04, +2.700164135410e-05),
    complex(-8.624645708907e-05, -6.973508294063e-06),
    complex(-5.847292154680e-05, -2.345344861452e-05),
    complex(-3.596939928879e-05, -2.876103508679e-05),
    complex(-1.937757217606e-05, -2.769035662990e-05),
]
