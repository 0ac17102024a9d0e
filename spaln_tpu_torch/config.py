"""Typed configuration tree.

One frozen-dataclass tree replacing the reference's global mutable parameter
structs with identical semantics and defaults:
  AlnPrm    <- ALPRM   (simmtx.cc:47 + setdefparam spaln.cc:1471-1494)
  AlnPrm2   <- ALPRM2  (simmtx.cc:49)
  AlgMode   <- ALGMODE (clib.h:38-55 + setdefparam)
  IntronPrm <- INTRONPEN (codepot.cc:38-47)
FQUERY-style deferred defaults are resolved by ``resolve()`` exactly as
prePwd/PwdB do (aln2.cc:66-96): dvsp-dependent splice weights, sss mix, etc.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

FQUERY = None           # deferred default marker (reference FQUERY sentinel)

# species-vs-universal splice-signal mix by cross-species level
DEF_SSS = (0.3, 0.50, 0.7)            # aln.h:53 defSss
DEF_PRM2_Y = ((4., 4.), (8., 8.))     # codepot.cc:66 defprm2 [dvsp>0][y,Y]
AVRSIG53 = (2.446, 4.807)             # codepot.cc:67
DEF_ALPRM2Z = 2.0                     # coding-potential weight for protein


@dataclass(frozen=True)
class AlnPrm:
    """Gap/scale parameters (ALPRM)."""
    u: float | None = FQUERY     # gap extension (per-matrix default)
    v: float | None = FQUERY     # gap open
    u0: float = 0.
    u1: float = 0.6              # long-gap extension (double affine)
    v0: float = 0.
    tgapf: float = 1.0           # terminal gap factor
    thr: float = 35.             # score threshold
    scale: int = 10              # fixed-point scale (int build)
    maxsp: float = 8.
    gamma: float = 0.5
    k1: int = 7                  # double-affine flex point
    ls: int = 2                  # # gap states (2 = single affine)
    sh: int = 100                # band shoulder (-w)
    mtx_no: int = 0
    # substitution-model knobs (readalprm m/n/b/p/q, spaln.cc/simmtx.cc)
    smn_match: float | None = None    # -ym DNA match (smn[0])
    smn_mismatch: float | None = None  # -yn DNA mismatch
    mtx_bias: float | None = None     # -yb protein matrix bias
    pam1: int | None = None           # -yp final-phase PAM level
    pam2: int | None = None           # -yq HSP-search PAM level


@dataclass(frozen=True)
class AlnPrm2:
    """Splice/coding parameters (ALPRM2)."""
    x: float = 30.               # frameshift penalty
    y: float | None = FQUERY     # splice-signal weight
    z: float | None = FQUERY     # coding-potential weight
    o: float = 30.               # premature-stop penalty
    m: float = 9.
    bti: float = 8.              # translation init/term weight
    spb: float = 20.             # conserved splice-position bonus
    Z: float = 0.                # intron-potential weight
    sss: float | None = FQUERY   # species-specific signal mix (-yS)
    jneibr: int = 10             # junction neighborhood window
    termk1: int = 45
    desert: int = 150
    # terminal-exon match weight (wmm).  ALPRM2 default is 9 but the
    # default algmode.crs=3->1 (clib.cc:45, aln2.cc:89,95) forces w=1
    # in every default run; we bake the effective default
    w: float = 1.
    # branch-point signal (BPPRM, aln.h:93; defaults simmtx.cc:54 —
    # factor 0 = off, enable with -yB; acceptors within maxb3d of a
    # strong Branch-PSSM hit get the bp bonus added to sig3)
    bp_factor: float = 0.
    bp_maxb3d: int = 100


@dataclass(frozen=True)
class AlgMode:
    """Algorithm mode bits (ALGMODE after setdefparam)."""
    lcl: int = 15                # semi-global ends
    lsg: int = 1                 # spliced alignment
    qck: int = 3                 # HSP search recursion levels (-Q)
    mlt: int = 0                 # single alignment per query
    mns: int = 3                 # both strands
    thr: int = 1                 # filter weak matches
    crs: int = 0                 # cross-species level
    any: int = 0                 # non-canonical splice tolerance (-ya)
    alg: int = 1                 # DP engine variant (-A)
    bnd: int = 1


@dataclass(frozen=True)
class IntronPrm:
    """Intron-length-distribution parameters (INTRONPEN, codepot.cc:38-47).

    Frechet mixture (a1,m1,t1,k1 / m2,t2,k2 / a2,m3,t3,k3) fitted per
    species (-yI / AlnParam); defaults = Dictyostelium-ish generic."""
    ip: float | None = FQUERY    # expected intron cost (12 nt / 15 aa)
    fact: float | None = FQUERY  # ILD weight (-yY; 4 nt / 8 aa)
    mean: float = -2.767
    llmt: int = 20
    mu: int = 224
    rlmt: int = 825
    elmt: int = 2
    tlmt: int = 5
    minl: int = 20
    maxl: int = 0
    mode: int = 0
    nquant: int = 5
    a1: float = 0.2767
    m1: float = -22.80
    t1: float = 83.35
    k1: float = 5.488
    m2: float = 21.870
    t2: float = 223.95
    k2: float = 0.7882
    a2: float = 0.
    m3: float = 0.
    t3: float = 0.
    k3: float = 0.


@dataclass(frozen=True)
class OutPrm:
    """Output options (OUTPRM subset)."""
    max_out: int = 1
    skip_long_gap: int = 1
    fmt: int = 3                 # -O output format number


@dataclass(frozen=True)
class Config:
    aln: AlnPrm = field(default_factory=AlnPrm)
    aln2: AlnPrm2 = field(default_factory=AlnPrm2)
    alg: AlgMode = field(default_factory=AlgMode)
    intron: IntronPrm = field(default_factory=IntronPrm)
    out: OutPrm = field(default_factory=OutPrm)


# dvsp codes (aln2.cc:86): 0 = cDNA x genome, 1/2 = protein x genome,
# 3 = protein x protein, 4 = tron x tron
CvsG, PvsG, GvsP, PvsP, TvsT = 0, 1, 2, 3, 4


def resolve(cfg: Config, dvsp: int) -> Config:
    """Resolve FQUERY-deferred defaults for a given comparison mode
    (prePwd + IntronPenalty ctor, aln2.cc:84-96, codepot.cc:129-133)."""
    y, Y = DEF_PRM2_Y[1 if dvsp > 0 else 0]
    a2 = cfg.aln2
    a2 = replace(a2,
                 y=a2.y if a2.y is not None else y,
                 sss=a2.sss if a2.sss is not None else DEF_SSS[cfg.alg.crs],
                 z=a2.z if a2.z is not None else
                 (DEF_ALPRM2Z if dvsp else 0.))
    it = cfg.intron
    it = replace(it,
                 fact=it.fact if it.fact is not None else Y,
                 ip=it.ip if it.ip is not None else (15. if dvsp else 12.))
    return replace(cfg, aln2=a2, intron=it)


def apply_y_args(cfg: Config, tokens: list[str]) -> Config:
    """Apply spaln ``-y*`` parameter tokens (readalprm, simmtx.cc:
    621-705) to the config tree — used both for explicit CLI options and
    for the species AlnParam file re-fed as arguments (readargs,
    spaln.cc:518-553)."""
    aln, a2, it, alg = cfg.aln, cfg.aln2, cfg.intron, cfg.alg
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if not tok.startswith("-y") or len(tok) < 3:
            continue
        opt = tok[2]
        vl = tok[3:]
        if not vl and i < len(tokens) and not tokens[i].startswith("-"):
            vl = tokens[i]
            i += 1
        vl = vl.strip()
        if opt == 'I':
            v = vl.strip('"\'')
            f = [float(x) for x in v.split()]
            upd = dict(a1=1., a2=0.)
            keys = ("llmt", "rlmt", "mean", "a1", "m1", "t1", "k1",
                    "m2", "t2", "k2", "a2", "m3", "t3", "k3")
            for key, x in zip(keys, f):
                upd[key] = int(x) if key in ("llmt", "rlmt") else x
            it = replace(it, **upd)
            continue
        if not vl:
            continue
        try:
            x = float(vl.split(':')[0].rstrip('"'))
        except ValueError:
            continue
        if opt == 'a':
            alg = replace(alg, any=int(x))
        elif opt == 'c':
            a2 = replace(a2, jneibr=int(x))
        elif opt == 'd':
            a2 = replace(a2, desert=int(x))
        elif opt == 'e':
            aln = replace(aln, u0=x)
        elif opt == 'f':
            aln = replace(aln, v0=x)
        elif opt == 'g':
            aln = replace(aln, gamma=x)
        elif opt == 'i':
            it = replace(it, ip=x)
        elif opt == 'j':
            aln = replace(aln, u1=x)
        elif opt == 'k':
            aln = replace(aln, k1=int(x))
        elif opt == 'l':
            aln = replace(aln, ls=int(x))
        elif opt == 'b':
            aln = replace(aln, mtx_bias=x)
        elif opt == 'm':
            aln = replace(aln, smn_match=x)
        elif opt == 'n':
            aln = replace(aln, smn_mismatch=x)
        elif opt == 'p':
            aln = replace(aln, pam1=int(x))
        elif opt == 'q':
            aln = replace(aln, pam2=int(x))
        elif opt == 'o':
            a2 = replace(a2, o=x)
        elif opt == 't':
            aln = replace(aln, tgapf=x)
        elif opt == 'u':
            aln = replace(aln, u=x)
        elif opt == 'v':
            aln = replace(aln, v=x)
        elif opt == 'w':
            aln = replace(aln, sh=int(x))
        elif opt == 'x':
            a2 = replace(a2, x=x)
        elif opt == 'y':
            a2 = replace(a2, y=x)
        elif opt == 'z':
            a2 = replace(a2, z=x)
        elif opt == 'A':
            a2 = replace(a2, bti=x)
        elif opt == 'B':
            a2 = replace(a2, bp_factor=x)
        elif opt == 'D':
            a2 = replace(a2, bp_maxb3d=int(x))
        elif opt == 'E':
            it = replace(it, elmt=int(x))
        elif opt == 'J':
            a2 = replace(a2, spb=x)
        elif opt == 'K':
            a2 = replace(a2, termk1=int(x))
        elif opt == 'L':
            it = replace(it, llmt=int(x), minl=int(x))
        elif opt == 'M':
            it = replace(it, maxl=int(x))
        elif opt == 'Q':
            it = replace(it, nquant=int(x))
        elif opt == 'S':
            a2 = replace(a2, sss=(x / 100. if x > 1. else x))
        elif opt == 'T':
            it = replace(it, tlmt=int(x))
        elif opt == 'Y':
            it = replace(it, fact=x)
    return replace(cfg, aln=aln, aln2=a2, intron=it, alg=alg)
