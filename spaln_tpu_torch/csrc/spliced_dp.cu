// Banded spliced DP of one geometry bucket on an NVIDIA Hopper GPU:
// four kernels (the slab kernel a template over three modes and the
// double-affine switch) behind thirteen entries of a plain C interface (bound
// with ctypes by spaln_tpu_torch/ops/dp_spliced_cuda.py, which also holds
// their plain PyTorch versions).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libspliced_dp.so spliced_dp.cu
//
// Every entry launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of its launch.  All arithmetic is int32 x10
// fixed point and follows the operation order of spaln_tpu's scan step
// (spaln_tpu/ops/dp_spliced_scan.py:223-577), which fixes every
// tie-break, so results equal the reference's exactly.
//
// States: 0 H (diagonal), 1 E (horizontal gap), 2 F (vertical gap) and,
// with double-affine gaps (DAGP, Spaln -yl3), 3 E2 and 4 F2: long gaps
// with their own open/extend costs lgop/lgep.  NS = 3 or 5 states.
//
// Layouts (row-major; nb = CTAs of the launch, one per problem):
//   qprof (B, Mpad, A)        substitution row of query residue m-1
//   gops  (B, 6, Np)          per genome boundary n: residue g[n-1],
//                             donor mask, acceptor mask, sig5, acceptor
//                             base, donor dinucleotide code
//   joint (B, Np, 16)         acceptor term by donor dinucleotide
//   ipen  (Np,)               exact intron penalty by length
//   sel   (nb,)               operand problem of each CTA (retrace), or
//                             null for CTA b = problem b
//   slabs (nb,)               slab of each CTA (the retrace of pairs), or
//                             null for s0
//   flags (S', T, nb, L) u8   winner state | E open << 3 | F open << 4
//                             | E2 open << 5 | F2 open << 6 | local
//                             restart << 7, 255 = inactive cell (S'
//                             slabs run)
//   spj   (S', NS, T, nb, L)  1 + donor boundary of an intron closed into
//                             state k at the cell, 0 = none
//   row   (B, Np)             H(M, n);  rc (B, Mpad + 1) H(m, N)
//   bnd   (NB, nb, Np + 1)    scratch: H, F (and F2) of the previous
//                             slab's last row by genome boundary n;
//                             NB = 2, or 3 under DAGP
//   links (S, NLK, B, T)      UDH link streams per slab and step t:
//                             boundary H and F (lane L-1), final row
//                             (lane clamp(M - m0, 0, L-1)), right column
//                             (the lane with n == N, else 0) and, under
//                             DAGP (NLK = 5), boundary F2 (lane L-1)
//   snaps (S, NB, B, T + 2)   the slab's entry boundary rows over the
//                             columns lane 0 reads, n = m0 + lw + k
//   snap  (NB, nb, T + 2)     a retrace's entry boundary (from snaps;
//                             of each CTA's own slab for pairs)
//   cip   (B, Mpad + L)       -yJ bonus of query row m at m - 1, added to
//                             every acceptor close of the row; or null
//   loc_v, loc_i (S, T, B)    local mode's emission: each slab's best H
//                             at each step over its lanes, and the first
//                             lane that holds it; or null
//   ends  (B, 3)              (score, end m, end n)
//   starts (nw, 5)            strip walk start (m, n, state, m_stop,
//                             problem column b of the planes)
//   slab0 (B,)                first slab of each column's planes, or
//                             null for s0
//   recs  (IT, nw, 4)         walk records (kind, m, n, jnc - 1) of nw
//                             walks (B for the full walk), zeroed by the
//                             caller
//   stats (nw, 2)             each walk's steps (records written) and
//                             tile loads, or null
// A link is column * 8 + state: where the cell's path crossed the
// previous slab boundary (state 0 = H, 2 = F, 4 = F2).
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEV = -939524096;          // NEVSEL (cmn.h:79, int build)
constexpr int NCAND = 4;                 // donor candidates per lane
constexpr int N_GOPS = 6;
enum { G_RES, G_ISDON, G_ISACC, G_SIG5, G_ACCB, G_DINC5 };
// psp orphan-exon bit per state H, E, F, E2, F2 (aln.h:56-59)
__device__ __constant__ int PSP_BIT[5] = {4, 1, 8, 2, 16};
enum { MODE_TRACE, MODE_LINKS, MODE_SCORE };
// the slab kernel's K6 instances: off (the main path), the local and -yJ
// modes, and those with the local mode's emission (trace mode only); and
// the retrace of (problem, slab) pairs, K6 off with a slab a CTA (its own
// instances, so that the main path's read no slab index)
enum { K6_OFF, K6_MODES, K6_EMIT, K6_PAIRS };

// Knock-outs of the score mode, for timing only: a build with
// -DSLAB_ABLATE=n drops one piece of the step from slab_kernel<MODE_SCORE,
// *>, the counterpart of spaln_tpu's SPALN_PALLAS_ABLATE
// (ops/dp_spliced_pallas.py:215; scripts/ablate_pallas.py), and computes
// wrong scores.  Without the define (0) the kernel is the production one.
//   NOSCORE  score = residue code + the lane's class-0 row (358)
//   NOEDGE   left = H of the previous step: no band-edge, column-0 or
//            top-of-band selects, no reset at the band's first cell (378)
//   NOIPEN   no intron-penalty gather: the candidate keeps 0 (455)
//   NOCLOSE  no acceptor close (473)
//   NOPUSH   no donor push (515)
//   NOEMIT   no final-row, right-column or boundary-row writes (559)
// NOCLOSE leaves the candidates no reader, and NOPUSH leaves them at
// NEV, so nvcc drops the other piece with each.  Two more knock-outs
// split the two and keep the other piece's work (their code is under
// #if, so that every other build compiles what it compiled before):
//   NOCLOSE_LIVE (7)  no acceptor close; the final-row write also reads
//                     the last candidate, so the donor push stays live
//   NOPUSH_LIVE (8)   no donor push; each lane's candidates start from
//                     the gap-open penalty (a value nvcc cannot see),
//                     so the close runs at every acceptor as it does
//                     once donors have pushed
// Values 9-17 are the counterparts of scripts/time_kernel_pieces.py's
// and scripts/bisect_mosaic.py's textual variants of the Pallas kernel
// (probes/time_kernel_pieces.py maps every variant to its value):
//   NOFILLS (9)       lane 0 never reads the previous slab's boundary
//                     row: its up, diagonal and F neighbours are NEV
//   NORECUR (10)      H = the lane's previous H + score: the diagonal
//                     dependence dropped
//   NOPSP (11)        psp carried unchanged through the E update
//   MIN_BODY (12)     _cut_body's three stand-ins: the recurrence as
//                     diag + score + left - up + up_F - E with E, F one
//                     and two below it, the close as the sum of its
//                     operands (acceptor base, sig5, dinucleotide, four
//                     joint terms, the site bits), no push
//   RECUR_ONLY (13)   the recurrence kept, the close's stand-in, no push
//   RECUR_CLOSE (14)  the recurrence and the close kept, no push; the
//                     candidates start live as NOPUSH_LIVE's do
//   RECUR_PUSH (15)   the recurrence and the push kept, the close's
//                     stand-in; the final-row write reads the last
//                     candidate as NOCLOSE_LIVE's does
//   ALL_OFF (16)      NOIPEN, NOCLOSE, NOPUSH, NOEMIT and NOFILLS at once
//   ALL_OFF_NOEDGE (17)  ALL_OFF and NOEDGE
// A knock-out build (SLAB_ABLATE > 0) instantiates the score mode alone;
// its other entries refuse (cudaErrorNotSupported).
#ifndef SLAB_ABLATE
#define SLAB_ABLATE 0
#endif
enum { ABL_NONE, ABL_NOSCORE, ABL_NOEDGE, ABL_NOIPEN, ABL_NOCLOSE,
       ABL_NOPUSH, ABL_NOEMIT, ABL_NOCLOSE_LIVE, ABL_NOPUSH_LIVE,
       ABL_NOFILLS, ABL_NORECUR, ABL_NOPSP, ABL_MIN_BODY, ABL_RECUR_ONLY,
       ABL_RECUR_CLOSE, ABL_RECUR_PUSH, ABL_ALL_OFF, ABL_ALL_OFF_NOEDGE };
// KO(piece): the build drops the piece; KEEP(piece): it runs.  Below 16
// a build drops the one piece its value names (the text every build
// below 16 compiled before the combinations existed); 16 and 17 drop
// several.
#if SLAB_ABLATE >= 16
__host__ __device__ constexpr bool ko_combo(int abl, int piece) {
  return (abl == ABL_ALL_OFF || abl == ABL_ALL_OFF_NOEDGE)
         && (piece == ABL_NOIPEN || piece == ABL_NOCLOSE
             || piece == ABL_NOPUSH || piece == ABL_NOEMIT
             || piece == ABL_NOFILLS
             || (piece == ABL_NOEDGE && abl == ABL_ALL_OFF_NOEDGE));
}
#define KO(piece) ko_combo(ABL, piece)
#define KEEP(piece) !ko_combo(ABL, piece)
#else
#define KO(piece) ABL == piece
#define KEEP(piece) ABL != piece
#endif

// Geometry of the slab kernel; slab_geometry in ops/dp_spliced_cuda.py
// holds the same numbers and picks k from them.
//   max_threads: the __launch_bounds__ of each instance, from its
//     registers (nvcc -Xptxas -v) so that none spills;
//   STAGE_C: genome columns per staged chunk; the ring holds
//     k * L + 2 * STAGE_C columns;
//   slab_smem_ints: the dynamic shared memory of one CTA, and
//     EMIT_INTS more where it emits K6's local steps;
//   CLUSTER_MAX: CTAs per problem at most (a portable cluster);
//   LANES_PER_THREAD: lanes a thread runs at most (a slab wider than
//     max_threads);
//   EMIT_SLOTS: (warp, sub-slab) partials of the emission at most, warps
//     plus sub-slabs (at most 28 + 7 at 896 threads).
constexpr int STAGE_C = 32;
constexpr int CLUSTER_MAX = 8;
constexpr int LANES_PER_THREAD = 2;
constexpr int EMIT_SLOTS = 64;
constexpr int EMIT_INTS = 4 * EMIT_SLOTS;    // two buffers of (value, lane)

// A timing build with -DSLAB_EMIT_ROWS=1 replaces the emission's
// reduction from registers by the form it was measured against: each
// step stores its lanes' H into rows of KL | 1 ints after the
// substitution rows (EC of them, STAGE_C or as many as the launch's
// shared memory holds), and every EC steps, after the step's barrier, a
// thread a (sub-slab, step) scans one row's L values, then one more
// barrier frees the rows.  No path runs it; chip_smoke.py
// --emission-timing holds it against the production build.
#ifndef SLAB_EMIT_ROWS
#define SLAB_EMIT_ROWS 0
#endif

constexpr int max_threads(int mode, bool dagp) {
  return mode == MODE_TRACE ? (dagp ? 640 : 896)
                            : mode == MODE_LINKS ? 512 : (dagp ? 512 : 1024);
}

__host__ __device__ inline int slab_smem_ints(int KL, int A, int mode,
                                              bool dagp) {
  const int rings = 5 + (dagp ? 2 : 0);      // H x3, F x2 (, F2 x2)
  const int links = mode == MODE_LINKS ? rings : 0;
  // joint rows (16) and packed operands (3) per ring column, two landing
  // chunks of the six raw operand rows, rings, substitution rows
  return 19 * (KL + 2 * STAGE_C) + 12 * STAGE_C + (rings + links) * KL
         + KL * A;
}

__device__ __forceinline__ int colinit(int k, int b_exgl, int gop,
                                       int gep) {
  // H[m][0]: free query prefix, or an affine gap of length k
  return (b_exgl || k == 0) ? 0 : gop + gep * k;
}

// ------------------------------------------------------- K1, K4 and K5
// slab_kernel<MODE_TRACE, false> (spliced_slab_trace, K1) replaces
// spaln_tpu's Pallas kernel _make_kernel(emit_trace=True)
// (ops/dp_spliced_pallas.py:195-694, via _slab_call 698-835) and the
// per-slab loop of _fused_call (1103-1121).  Its retrace mode
// (spliced_slab_retrace) runs slabs s0 .. s0+nslab-1 of selected problems
// from an entry boundary the caller restores from K4's snapshot: the
// per-slab _scan_slab(emit_trace=True) re-run of
// ops/dp_spliced_udh.py:_retrace (157-201).  Its pairs form
// (spliced_slab_retrace_pairs) runs one (problem, slab) pair a CTA, each
// from its own slab's snapshot: the reference's re-run of every slab
// from its own snapshot after a local or -yJ links pass, all slabs of a
// bucket in one launch (k = 1, one CTA a pair, several to an SM).
//
// slab_kernel<MODE_LINKS, false> (spliced_slab_links, K4) replaces
// _make_kernel(emit_links=True) (reached through
// run_spliced_batch_pallas(score_only=True, emit_links=True),
// dp_spliced_pallas.py:991): the same recurrence with no planes, every
// value carrying the link of its path's last slab-boundary crossing
// through the same selects (dp_spliced_scan.py:347-366, 372-551).
//
// K5 is the kernel's two remaining modes.  slab_kernel<MODE_SCORE, *>
// (spliced_slab_score) replaces _make_kernel(emit_trace=False), the
// score-only forward (run_spliced_batch_pallas(score_only=True),
// dp_spliced_pallas.py:991-1070): no planes and no links, only the final
// row and right column for K2e.  DAGP = true (the *_dagp entries) adds
// the long-gap states E2/F2 of _make_kernel(dagp=True) to each mode; for
// the links mode the reference runs its scan engine instead (the Pallas
// links mode asserts not dagp, dp_spliced_pallas.py:213).
//
// Design: one CTA per problem runs k consecutive slabs of it at once
// ("tall slab"): k sub-slabs of L lanes step in lockstep, one
// __syncthreads() per global step.  Sub-slab j of round r runs slab
// s0 + r*k + j and is at its local step t = tau - 2*j*L at global step
// tau, so a round takes T + 2*(k-1)*L global steps where the slabs one
// after another took k*T.  Lane i of a sub-slab owns query row
// m = m0 + i of its slab and at local step t computes cell
// n = m0 + lw + 1 + t - i.  Up and diagonal values come from lane i-1
// of the same sub-slab through a ring in shared memory (H of steps t-1
// and t-2, F and F2 of step t-1, and their links); E and E2 stay in the
// lane's registers (struct Lane).  A thread runs P lanes, v = thread +
// p * threads (p < P): P = 1 (one lane a thread) up to the instance's
// thread budget, P = 2 for a slab of up to twice as many lanes (then
// k = 1).  A lane reads the ring slots of steps t-1 and t-2 and writes
// that of step t, so the lanes of a thread may run in any order within
// a step.
//
// Lane 0 of every sub-slab reads the previous slab's last row from the
// global boundary row bnd, which lane L-1 of the previous sub-slab (or,
// at a round's start, of the previous round's last sub-slab) writes for
// its active cells.  Lane 0 of slab s reads column c at global step x;
// slab s-1 wrote c at x - 1, slabs before it earlier still, and slab s
// itself and the slabs after it write c only later (L >= 3).  So the
// columns lane 0 reads are exactly the row as it stood when slab s would
// have started in the slabs' sequential order, stale band-edge columns
// included: K4 records each value lane 0 reads as the slab's snapshot
// (the one column it never reads, T+1, no earlier slab writes, so it is
// copied at the round's start), and a retrace restores it.  Lane 0 takes
// nothing from the ring, so its links keep the boundary form.
//
// The genome operands of the step come from shared memory: a ring of
// k*L + 2*STAGE_C columns, the window the CTA reads (k*L columns, moving
// one column a step) and two chunks ahead.  At the end of every
// STAGE_C-th step each staging thread waits for the chunk it issued
// STAGE_C steps before, packs its six operand rows into three words
// (residue, donor and acceptor masks and dinucleotide code in one: the
// residue is < A <= 256, the masks 0/1, the code < 16; sig5 and the
// acceptor base are full ints) and issues the next chunk with cp.async:
// the raw rows into a double-buffered landing area, the joint rows
// (16 ints a column) straight into the ring.  The intron penalty is
// gathered from the dense table through the read-only path, for the four
// candidates of an acceptor close before the neighbour values are read,
// so that its loads overlap lane 0's.  In the trace and score modes an
// inactive cell (outside the band or the matrix) skips the recurrence:
// it emits NEV and flag 255 and changes no state a later cell reads.
//
// Several SMs per problem: a problem whose slabs take more than one
// round runs on a cluster of ncta CTAs; CTA q runs rounds q, q + ncta,
// ...  Round r+1's sub-slab 0 reads what round r's last sub-slab writes,
// as a round does in one CTA, so round r+1 may start 2*k*L global steps
// after round r instead of after its end: at the end of every STAGE_C-th
// step a round publishes the steps it has done (a release store after
// the barrier), and round r+1 waits until round r is 2*k_r*L + STAGE_C
// steps ahead of it (an acquire load) or done.  Then every write of an
// earlier slab to a column lands before lane 0 reads it and every write
// of a later slab after, as in one CTA, so the outputs do not change;
// lane 0 reads bnd through L2 there (other SMs write it).  The clusters keep
// the CTAs of a problem on the card together, so the waits cannot
// deadlock.  MULTI = true is the instance for more than one CTA per
// problem; one CTA per problem keeps its L1 loads and its registers.
//
// Bound on the H100: the serial dependence through the wavefront, one
// barrier per step and the step's instructions.  B problems (<= 32 on
// the map path, 64 on the protein search's score pass) take B CTAs of
// the 132 SMs, or up to 8 each (and 132 in all) where they have more
// rounds than one; k sub-slabs put k times the warps of one slab on
// each SM, so the step becomes bound by the issue of the acceptor-close
// and donor-push selects of k*L/32 warps rather than by the latency of
// one (PERF.md: per global step K1 at k = 7 takes about twice one
// slab's step, for seven slabs).  K1's plane writes, 13 B per cell
// (21 B under DAGP), are its only large traffic; K4 writes 16-20 B per
// step and problem instead, and the score mode nothing but the final
// row and column.
//
// K6, the local (Smith-Waterman-Gotoh) and -yJ modes of K1 and K4: the
// counterpart of _make_step(local=True, cip=True)
// (ops/dp_spliced_scan.py:223, run by _scan_slab 592), which spaln_tpu
// runs on its scan engine only.  They are compiled into the K6_MODES
// instances of the trace and links modes, and with the emission into
// the K6_EMIT instances of the trace mode; there the local mode and the
// bonus are runtime switches, uniform across the launch.  The main path
// (no local mode, no bonus) runs the K6_OFF instances, the code it ran
// before K6 (as runtime switches they cost K4 5.5% at phase 1's bucket:
// PERF.md); the emission has instances of its own because its registers
// made the K6 trace instance spill (K1 local +11% at phase 1's bucket
// against +2% without them: PERF.md); the score mode,
// which no path runs in them, has no K6 instance:
//   cip    a lane's bonus is constant over its slab: loaded into a
//          register at the round's start and added to the acceptor base
//          once per closing cell (the same sum at every candidate);
//   local  an active cell whose H is <= 0 commits 0 and sets flag bit 7
//          (the walks stop there); the donor push and the E/F states
//          read the value before the floor, as the reference does;
//   loc_v  (trace mode, only asked for by the local protein search)
//          each slab's best committed H at each step and its first lane,
//          reduced from the registers that hold it: at the end of its
//          step each warp reduces its own lanes of each sub-slab to a
//          (best, first lane) partial (__reduce_max_sync, then a ballot,
//          or __reduce_min_sync at two lanes a thread) in a small
//          double-buffered array after the substitution rows (EMIT_INTS,
//          asked for by the launch), and after the step's barrier one
//          thread a sub-slab combines its few partials and stores them.
//          No extra barrier; the round's last step is combined after the
//          loop, before the barrier that starts the next round.  (The
//          earlier form, each warp scanning a sub-slab's L values in the
//          H ring before its next step, cost +50% on a search batch; the
//          SLAB_EMIT_ROWS form above is timed against this one: PERF.md.)
// One lane's registers: its place in the CTA's round (set at the round's
// start) and the DP state it carries from one step to the next.
struct Lane {
  int i, j, ls, m0, m, col_m, col_m1, li, slot;
  bool live, internal;
  unsigned char* fl_out;
  int* spj_out;
  int* lk_out;
  int* sn_out;
  int h1, e1, e2, psp, lkh1, lke, lke2;
  int cipv;                     // -yJ bonus of the lane's row (K6)
  int cv[NCAND], cj[NCAND], cd[NCAND], c5[NCAND], lkc[NCAND];
};

#if SLAB_ABLATE == 8 || SLAB_ABLATE == 14
// NOPUSH_LIVE's and RECUR_CLOSE's candidates (timing only): values from the gap-open
// penalty, which nvcc cannot see, live (> NEV / 2), of state < ns and
// with an intron start near 0
__device__ __forceinline__ void seed_live(Lane& x, int gop, int ns) {
#pragma unroll
  for (int l = 0; l < NCAND; ++l) {
    const unsigned u = (unsigned)gop + l;
    x.cv[l] = gop;
    x.cj[l] = u & 7;
    x.cd[l] = u % ns;
    x.c5[l] = u & 15;
  }
}
#endif

template <int MODE, bool DAGP, bool MULTI, int MAXT, int P, int K6>
__global__ void __launch_bounds__(MAXT)
slab_kernel(const int* __restrict__ qprof, const int* __restrict__ gops,
            const int* __restrict__ joint, const int* __restrict__ ipen,
            const int* __restrict__ Ms, const int* __restrict__ Ns,
            const int* __restrict__ lws, const int* __restrict__ sel,
            const int* __restrict__ slabs, int A, int L, int s0, int nslab,
            int W, int T, int Mpad,
            int Np, int gop, int gep, int lgop, int lgep, int llmt,
            int a_exgl, int a_exgr, int b_exgl,
            const int* __restrict__ snap, int* bnd,
            unsigned char* __restrict__ flags, int* __restrict__ spj,
            int* __restrict__ row, int* __restrict__ rc,
            int* __restrict__ links, int* __restrict__ snaps, int ncta_arg,
            int* prog, const int* __restrict__ cip, int local,
            int* __restrict__ loc_v, int* __restrict__ loc_i) {
  constexpr bool LINKS = MODE == MODE_LINKS;
  constexpr bool TRACE = MODE == MODE_TRACE;
  constexpr bool EMIT = TRACE && K6 == K6_EMIT;  // loc_v, loc_i set
  constexpr bool MODES = K6 == K6_MODES || EMIT;  // local, cip switches
  constexpr int NS = DAGP ? 5 : 3;        // states with a junction plane
  constexpr int NB = DAGP ? 3 : 2;        // boundary rows H, F (, F2)
  constexpr int NLK = DAGP ? 5 : 4;       // link streams per slab
  constexpr int C = STAGE_C;
  constexpr int ABL = MODE == MODE_SCORE ? SLAB_ABLATE : ABL_NONE;
  extern __shared__ int smem[];
  const int nthr = blockDim.x;               // P lanes a thread
  const int ksub = nthr * P / L;             // k sub-slabs of L lanes
  const int KL = ksub * L;
  const int g = threadIdx.x;
  const int ncta = MULTI ? ncta_arg : 1;     // CTAs per problem
  const int ob = blockIdx.x / ncta;          // output slot
  const int cq = blockIdx.x - ob * ncta;     // CTA of the problem
  const int nb = gridDim.x / ncta;
  const int b = sel ? sel[ob] : ob;          // operand problem
  const int sb = K6 == K6_PAIRS ? slabs[ob] : s0;   // its first slab
  const int R = KL + 2 * C;                  // staged genome columns
  int* jr = smem;                            // R x 16 joint rows
  int* gw = jr + 16 * R;                     // R packed small operands
  int* gs5 = gw + R;                         // R sig5
  int* gab = gs5 + R;                        // R acceptor base
  int* land = gab + R;                       // 2 x 6 x C raw operand rows
  int* Hs = land + 12 * C;                   // 3 x KL: H by step mod 3
  int* Fs = Hs + 3 * KL;                     // 2 x KL: F by step mod 2
  int* F2s = Fs + 2 * KL;                    // 2 x KL: F2 (DAGP)
  int* HLs = F2s + (DAGP ? 2 * KL : 0);      // 3 x KL: H links (K4)
  int* FLs = HLs + (LINKS ? 3 * KL : 0);     // 2 x KL: F links (K4)
  int* F2Ls = FLs + (LINKS ? 2 * KL : 0);    // 2 x KL: F2 links (K4, DAGP)
  int* qp = F2Ls + (LINKS && DAGP ? 2 * KL : 0);  // KL x A substitution rows
#if SLAB_EMIT_ROWS
  int* ebuf = qp + KL * A;                   // EC x ES (K6 emission)
  const int ES = KL | 1;                     // its row stride, odd
  int EC = 1;                                // its rows: steps a scan
  if constexpr (EMIT) {
    unsigned dsm;                            // the launch's bytes
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dsm));
    EC = min(C, ((int)dsm / 4 - slab_smem_ints(KL, A, MODE, DAGP)) / ES);
  }
#else
  int* lpart = qp + KL * A;                  // 2 x 2 x EMIT_SLOTS (K6 emission)
#endif
  const int M = Ms[b], N = Ns[b], lw = lws[b];
  const int nbnd = Np + 1;
  const int TS = T + 2;
  int* bh = bnd + (size_t)ob * nbnd;
  int* bf = bnd + ((size_t)nb + ob) * nbnd;
  int* bf2 = bnd + ((size_t)2 * nb + ob) * nbnd;       // DAGP only
  // bnd through L2 where other SMs write it (MULTI: several CTAs per
  // problem), else through L1
  auto ld_bnd = [](const int* p) {
    if constexpr (MULTI) return __ldcg(p);
    else return *p;
  };
  int* rowb = row ? row + (size_t)b * Np : nullptr;
  int* rcb = rc ? rc + (size_t)b * (Mpad + 1) : nullptr;
  const int* gb = gops + (size_t)b * N_GOPS * Np;
  const int* jb = joint + (size_t)b * Np * 16;
  const int nround = (nslab + ksub - 1) / ksub;
  const int g0 = cq * nthr + g, gstep = ncta * nthr;   // the problem's threads
  if (snap) {                 // entry boundary of slab sb (retrace)
    const int w0 = sb * L + 1 + lw;
    for (int n = g0; n < nbnd; n += gstep) {
      const int kk = n - w0;
      const bool in = kk >= 0 && kk < TS;
      bh[n] = in ? snap[(size_t)ob * TS + kk] : NEV;
      bf[n] = in ? snap[((size_t)nb + ob) * TS + kk] : NEV;
      if (DAGP) bf2[n] = in ? snap[((size_t)2 * nb + ob) * TS + kk] : NEV;
    }
  } else {                    // row 0
    for (int n = g0; n < nbnd; n += gstep) {
      bh[n] = n <= N ? (a_exgl ? 0 : colinit(n, 0, gop, gep)) : NEV;
      bf[n] = NEV;
      if (DAGP) bf2[n] = NEV;
    }
  }
  if (rowb)
    for (int n = g0; n < Np; n += gstep) rowb[n] = NEV;
  if (rcb)
    for (int m = g0; m <= Mpad; m += gstep) rcb[m] = NEV;
  // progress of each round in global steps, read by the next round
  int* prog_b = prog + (size_t)ob * nround;
  for (int r = g0; r < nround; r += gstep) prog_b[r] = 0;
  if constexpr (MULTI) cooperative_groups::this_cluster().sync();
  const int e_const =
      lw >= -M ? colinit(lw < 0 ? -lw : 0, b_exgl, gop, gep) : NEV;
  const size_t plane = (size_t)T * nb * L;   // one (T, nb, L) plane
  const size_t tstride = (size_t)nb * L;

  for (int r = cq; r < nround; r += ncta) {
    const int q0 = (sb + r * ksub) * L;         // query row of lane 0
    const int base = q0 + 2 + lw;            // column of lane 0, step 0
    const int nstep = T + 2 * (min(ksub, nslab - r * ksub) - 1) * L;
    // round r-1 (another CTA of the problem) must stay 2*k'*L steps
    // ahead of this one: wait until it has done `ahead` more steps than
    // this round, or all of its own
    const int kp = min(ksub, nslab - (r - 1) * ksub);
    const int nstep_p = T + 2 * (kp - 1) * L;
    const int ahead = 2 * kp * L + C;
    auto sync_rounds = [&](int done) {
      if constexpr (MULTI) {
        if (g == 0) {
          __threadfence();
          cuda::atomic_ref<int, cuda::thread_scope_device>(prog_b[r]).store(
              done, cuda::memory_order_release);
          if (r > 0) {
            cuda::atomic_ref<int, cuda::thread_scope_device> p(prog_b[r - 1]);
            const int need = min(done + ahead, nstep_p);
            while (p.load(cuda::memory_order_acquire) < need) {
            }
          }
          __threadfence();
        }
        __syncthreads();
      }
    };
    // genome columns base + q*C .. base + q*C + C-1 (chunk q) into the
    // ring slots (q*C + c) mod R; each staging thread packs the columns
    // it issued itself, so its own wait makes them visible to it
    auto issue = [&](int q) {
      for (int c = g; c < C; c += nthr) {
        const int n = base + q * C + c;
        if (n < 0 || n >= Np) continue;
        int* lb = land + (q & 1) * 6 * C + c;
#pragma unroll
        for (int x = 0; x < N_GOPS; ++x)
          __pipeline_memcpy_async(lb + x * C, gb + (size_t)x * Np + n, 4);
        int* jd = jr + ((q * C + c) % R) * 16;
#pragma unroll
        for (int w = 0; w < 16; w += 4)
          __pipeline_memcpy_async(jd + w, jb + (size_t)n * 16 + w, 16);
      }
      __pipeline_commit();
    };
    auto pack = [&](int q) {
      for (int c = g; c < C; c += nthr) {
        const int n = base + q * C + c;
        if (n < 0 || n >= Np) continue;
        const int* lb = land + (q & 1) * 6 * C + c;
        const int sl = (q * C + c) % R;
        gw[sl] = lb[G_RES * C] | (lb[G_ISDON * C] != 0) << 8
                 | (lb[G_ISACC * C] != 0) << 9 | (lb[G_DINC5 * C] & 15) << 10;
        gs5[sl] = lb[G_SIG5 * C];
        gab[sl] = lb[G_ACCB * C];
      }
    };
    __syncthreads();          // this CTA's previous round is done
    sync_rounds(0);
    // the thread's lanes v = g + p * nthr (p < P), those below KL live
    Lane ln[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      Lane& x = ln[p];
      const int v = g + p * nthr;
      x.j = v / L;                           // sub-slab
      x.i = v - x.j * L;                     // lane in the sub-slab
      x.ls = r * ksub + x.j;                 // its slab - sb
      x.live = v < KL && x.ls < nslab;
      const int s = sb + x.ls;
      x.m0 = s * L + 1;
      x.m = x.m0 + x.i;
      if (LINKS && x.live && x.i == 0) {     // snapshot entry T+1
        const int n = x.m0 + lw + T + 1;
        for (int rr = 0; rr < NB; ++rr)
          snaps[((size_t)(s * NB + rr) * nb + ob) * TS + T + 1] =
              (n >= 0 && n < nbnd)
                  ? ld_bnd(bnd + ((size_t)rr * nb + ob) * nbnd + n) : NEV;
      }
      if (v < KL) {
        Hs[v] = NEV; Hs[KL + v] = NEV; Hs[2 * KL + v] = NEV;
        Fs[v] = NEV; Fs[KL + v] = NEV;
        if (DAGP) { F2s[v] = NEV; F2s[KL + v] = NEV; }
        if (LINKS) {
          HLs[v] = 0; HLs[KL + v] = 0; HLs[2 * KL + v] = 0;
          FLs[v] = 0; FLs[KL + v] = 0;
          if (DAGP) { F2Ls[v] = 0; F2Ls[KL + v] = 0; }
        }
      }
      x.h1 = NEV; x.e1 = NEV; x.e2 = NEV; x.psp = 0;
#pragma unroll
      for (int l = 0; l < NCAND; ++l) {
        x.cv[l] = NEV; x.cj[l] = x.cd[l] = x.c5[l] = 0; x.lkc[l] = 0;
      }
#if SLAB_ABLATE == 8 || SLAB_ABLATE == 14
      if (ABL == ABL_NOPUSH_LIVE || ABL == ABL_RECUR_CLOSE)
        seed_live(x, gop, NS);
#endif
      x.lkh1 = 0; x.lke = 0; x.lke2 = 0;
      x.col_m = colinit(x.m, b_exgl, gop, gep);
      x.col_m1 = colinit(x.m - 1, b_exgl, gop, gep);
      x.internal = !a_exgr || x.m < M;
      x.cipv = MODES && cip && x.live ? cip[(size_t)b * (Mpad + L) + x.m - 1]
                                    : 0;
      x.li = min(max(M - x.m0, 0), L - 1);    // lane of row M
      x.fl_out = nullptr;
      x.spj_out = nullptr;
      x.lk_out = nullptr;
      x.sn_out = nullptr;
      if (LINKS) {
        x.lk_out = links + ((size_t)(s * NLK) * nb + ob) * T;
        x.sn_out = snaps + ((size_t)(s * NB) * nb + ob) * TS;
      } else if (TRACE) {
        x.fl_out = flags + (size_t)x.ls * plane + (size_t)ob * L + x.i;
        x.spj_out = spj + (size_t)x.ls * NS * plane + (size_t)ob * L + x.i;
      }
      x.slot = v == 0 ? 0 : R - v;           // ring slot of its column
    }
    const int* qsrc = qprof + (size_t)b * Mpad * A + (size_t)q0 * A;
    const int qlim = (Mpad - q0) * A;
    for (int x = g; x < KL * A; x += nthr) qp[x] = x < qlim ? qsrc[x] : 0;
    issue(0);
    __pipeline_wait_prior(0);
    pack(0);
    issue(1);
    __syncthreads();

    // one step of lane v (of this thread's lanes, x its registers) at
    // global step tau, p3 = tau mod 3
    auto lane_step = [&](Lane& x, const int v, const int tau,
                         const int p3) {
      const int i = x.i;
      const int t = tau - 2 * x.j * L;
      if (x.live && t >= 0 && t < T) {
        const int m = x.m;
        const int n = x.m0 + lw + 1 + t - i;
        const int r_off = t - 2 * i;
        const bool first = r_off == 0;
        const bool active =
            r_off >= 0 && r_off < W && n >= 1 && n <= N && m <= M;
        if (KEEP(ABL_NOEDGE) && first) {
          x.e1 = NEV;
          x.e2 = NEV;
          x.psp = 0;
#pragma unroll
          for (int l = 0; l < NCAND; ++l) {
            x.cv[l] = NEV; x.cj[l] = x.cd[l] = x.c5[l] = 0;
          }
#if SLAB_ABLATE == 8 || SLAB_ABLATE == 14
          if (ABL == ABL_NOPUSH_LIVE || ABL == ABL_RECUR_CLOSE)
            seed_live(x, gop, NS);
#endif
        }
        if (!LINKS && !active) {
          // Trace and score modes: an inactive cell emits H, F, F2 = NEV,
          // flag 255 and no junction, and leaves every state a later cell
          // of the lane reads as it was (a lane's active cells are one
          // run of steps; before it psp stays 0 from the reset above).
          // Links mode runs the recurrence: the F and E links it carries
          // through inactive cells reach the boundary streams.
          x.h1 = NEV;
          Hs[p3 * KL + v] = NEV;
          Fs[(tau & 1) * KL + v] = NEV;
          if (DAGP) F2s[(tau & 1) * KL + v] = NEV;
          if constexpr (TRACE) {
            x.fl_out[(size_t)t * tstride] = 255;
#pragma unroll
            for (int k = 0; k < NS; ++k)
              x.spj_out[(size_t)k * plane + (size_t)t * tstride] = 0;
          }
        } else {
          int score = 0, isdon = 0, isacc = 0, sig5 = 0, accb = 0;
          int dinc5 = 0;
          const int slot = x.slot;
          if (active) {
            const int w = gw[slot];
            score = ABL == ABL_NOSCORE ? (w & 255) + qp[v * A]
                                       : qp[v * A + (w & 255)];
            if (n < N) {
              isdon = (w >> 8) & 1;
              isacc = (w >> 9) & 1;
              sig5 = gs5[slot];
              accb = gab[slot];
              dinc5 = (w >> 10) & 15;
            }
          }
          // the intron penalties of an acceptor close, gathered before the
          // neighbour values so that their loads overlap lane 0's
#if SLAB_ABLATE == 7
          const bool closes = ABL != ABL_NOCLOSE_LIVE && isacc && x.internal;
#else
          const bool closes = KEEP(ABL_NOCLOSE) && isacc && x.internal;
#endif
          bool ok[NCAND];
          int pen[NCAND];
#pragma unroll
          for (int l = 0; l < NCAND; ++l) {
            const int ilen = n - x.cj[l];
            ok[l] = closes && ilen >= llmt && x.cv[l] > NEV / 2;
            pen[l] = !ok[l] || KO(ABL_NOIPEN) ? 0
                     : ilen < 0 ? NEV / 2 : __ldg(ipen + min(ilen, Np - 1));
          }
          // ---- neighbour values and their links; lane 0's sources sit on
          // the boundary row, so their link is their own (column, state)
          int up_h, up_f, diag_h, up_f2 = NEV;
          int lk_up_h = 0, lk_up_f = 0, lk_diag = 0, lk_up_f2 = 0;
          if (i == 0) {
#if SLAB_ABLATE == 9 || SLAB_ABLATE >= 16
            const bool in = KEEP(ABL_NOFILLS) && n >= 0 && n < nbnd;
#else
            const bool in = n >= 0 && n < nbnd;
#endif
            const int raw_h = in ? ld_bnd(bh + n) : NEV;
            const int raw_f = in ? ld_bnd(bf + n) : NEV;
            const int raw_f2 = DAGP && in ? ld_bnd(bf2 + n) : NEV;
            const bool ok_up = n >= 0 && n <= N + 1;
            up_h = ok_up ? raw_h : NEV;
            up_f = ok_up ? raw_f : NEV;
            if (DAGP) up_f2 = ok_up ? raw_f2 : NEV;
#if SLAB_ABLATE == 9 || SLAB_ABLATE >= 16
            diag_h = KEEP(ABL_NOFILLS) && n >= 1 && n - 1 <= N
                         ? ld_bnd(bh + n - 1) : NEV;
#else
            diag_h = (n >= 1 && n - 1 <= N) ? ld_bnd(bh + n - 1) : NEV;
#endif
            if (LINKS) {
              lk_up_h = n * 8;
              lk_up_f = n * 8 + 2;
              lk_up_f2 = n * 8 + 4;
              lk_diag = (n - 1) * 8;
              // the snapshot: entry t+1 is the column read here, entry 0
              // the diagonal of step 0
              int* sn = x.sn_out;
              sn[t + 1] = raw_h;
              sn[(size_t)nb * TS + t + 1] = raw_f;
              if (DAGP) sn[(size_t)2 * nb * TS + t + 1] = raw_f2;
              if (t == 0) {
                const bool in0 = n >= 1 && n - 1 < nbnd;
                sn[0] = in0 ? ld_bnd(bh + n - 1) : NEV;
                sn[(size_t)nb * TS] = in0 ? ld_bnd(bf + n - 1) : NEV;
                if (DAGP)
                  sn[(size_t)2 * nb * TS] = in0 ? ld_bnd(bf2 + n - 1) : NEV;
              }
            }
          } else {
            const int up = ((p3 + 2) % 3) * KL + v - 1;   // lane i-1, t-1
            const int dg = ((p3 + 1) % 3) * KL + v - 1;   // lane i-1, t-2
            const int up2 = ((tau + 1) & 1) * KL + v - 1;
            up_h = Hs[up];
            up_f = Fs[up2];
            if (DAGP) up_f2 = F2s[up2];
            diag_h = Hs[dg];
            if (LINKS) {
              lk_up_h = HLs[up];
              lk_up_f = FLs[up2];
              if (DAGP) lk_up_f2 = F2Ls[up2];
              lk_diag = HLs[dg];
            }
          }
          // column 0 and the band's left edge (dp_spliced_ref init); they
          // descend from column 0, link 0
          const bool edge = first && n != 1;
          const int left_h =
              KO(ABL_NOEDGE) ? x.h1
              : n == 1 ? x.col_m : (edge ? e_const : (first ? NEV : x.h1));
          const int lk_left = (n == 1 || first) ? 0 : x.lkh1;
          if (KEEP(ABL_NOEDGE)) {
            if (n == 1) { diag_h = x.col_m1; lk_diag = 0; }
            if (r_off >= W - 1) { up_h = NEV; up_f = NEV; up_f2 = NEV; }
          }
          // ---- recurrence (order = fwd2s1.cc:276-431)
          int sv[NS], jn[NS], lks[NS];
#if SLAB_ABLATE == 12
          // MIN_BODY's stand-in (wrapping, as the script's int32 sums)
          const bool f_open = false, e_open = false;
          const bool f2_open = false, e2_open = false;
          const int h_val =
              (int)((unsigned)diag_h + score + left_h - up_h + up_f - x.e1);
          int mx = h_val, mk = 0, lk_mx = lk_diag;
          sv[0] = h_val;
          sv[1] = (int)((unsigned)h_val - 1);
          sv[2] = (int)((unsigned)h_val - 2);
          if constexpr (DAGP) { sv[3] = sv[1]; sv[4] = sv[2]; }
          lks[0] = lk_diag; lks[1] = x.lke; lks[2] = lk_up_f;
          if constexpr (DAGP) { lks[3] = x.lke2; lks[4] = lk_up_f2; }
          (void)up_f2;
          (void)lk_up_h;
          (void)lk_left;
#else
#if SLAB_ABLATE == 10
          const int h_val = (KO(ABL_NORECUR) ? x.h1 : diag_h) + score;
#else
          const int h_val = diag_h + score;
#endif
          int mx = h_val, mk = 0, lk_mx = lk_diag;
          int xo = up_h + gop;                     // F: new gap >= extend
          const bool f_open = xo >= up_f;
          const int f_val = (f_open ? xo : up_f) + gep;
          const int lkf = f_open ? lk_up_h : lk_up_f;
          if (f_val > mx) { mx = f_val; mk = 2; lk_mx = lkf; }
          bool f2_open = false;
          if constexpr (DAGP) {                    // F2, strict > into the max
            xo = up_h + lgop;
            f2_open = xo >= up_f2;
            const int f2_val = (f2_open ? xo : up_f2) + lgep;
            const int lkf2 = f2_open ? lk_up_h : lk_up_f2;
            if (f2_val > mx) { mx = f2_val; mk = 4; lk_mx = lkf2; }
            sv[4] = f2_val;
            lks[4] = lkf2;
          }
          const int prev_psp = x.psp;              // pre-E value for E and E2
          xo = left_h + gop;
          const bool e_open = xo >= x.e1;
          const int e_val = (e_open ? xo : x.e1) + gep;
          if (e_open) x.lke = lk_left;
#if SLAB_ABLATE == 11
          x.psp = KO(ABL_NOPSP) ? prev_psp
                  : e_open ? (prev_psp != 0 ? 1 : 0) : (prev_psp & 1);
#else
          x.psp = e_open ? (prev_psp != 0 ? 1 : 0) : (prev_psp & 1);
#endif
          if (e_val >= mx) { mx = e_val; mk = 1; lk_mx = x.lke; }
          bool e2_open = false;
          if constexpr (DAGP) {                    // E2, >= into the max
            xo = left_h + lgop;
            e2_open = xo >= x.e2;
            const int e2_val = (e2_open ? xo : x.e2) + lgep;
            if (e2_open) x.lke2 = lk_left;
            x.psp = e2_open ? (prev_psp != 0 ? (x.psp | 2) : x.psp)
                            : (x.psp | (prev_psp & 2));
            if (e2_val >= mx) { mx = e2_val; mk = 3; lk_mx = x.lke2; }
            sv[3] = e2_val;
            lks[3] = x.lke2;
          }
          sv[0] = h_val; sv[1] = e_val; sv[2] = f_val;
          lks[0] = lk_diag; lks[1] = x.lke; lks[2] = lkf;
#endif
#pragma unroll
          for (int k = 0; k < NS; ++k) jn[k] = 0;
          // ---- acceptor close (fwd2s1.cc:333-354)
#if SLAB_ABLATE == 12 || SLAB_ABLATE == 13 || SLAB_ABLATE == 15
          {   // the close's stand-in: its operands summed (wrapping)
            unsigned h = (unsigned)mx + accb + sig5 + dinc5 + isdon
                         + 2 * isacc;
#pragma unroll
            for (int l = 0; l < NCAND; ++l) h += jr[slot * 16 + l];
            mx = (int)h;
#pragma unroll
            for (int k = 0; k < NS; ++k) sv[k] = mx;
          }
#else
          if (closes) {
            const int acc = MODES ? accb + x.cipv : accb;   // -yJ bonus
            int xc[NCAND];
#pragma unroll
            for (int l = 0; l < NCAND; ++l)
              xc[l] = ok[l] ? x.cv[l] + pen[l] + acc + jr[slot * 16 + x.c5[l]]
                            : NEV;
#pragma unroll
            for (int k = 0; k < NS; ++k) {
              int cur = sv[k], jnc = 0;
#pragma unroll
              for (int l = 0; l < NCAND; ++l)             // best-first order
                if (x.cd[l] == k && ok[l] && xc[l] >= cur) {
                  cur = xc[l];
                  jnc = x.cj[l] + 1;
                  lks[k] = x.lkc[l];
                }
              sv[k] = cur;
              jn[k] = jnc;
              if (jnc > 0) {
                x.psp |= PSP_BIT[k];
                if (cur >= mx) { mx = cur; mk = k; lk_mx = lks[k]; }
              }
            }
          }
#endif
          // ---- donor push (fwd2s1.cc:380-406): sorted insertion, ties keep
          // existing entries first; the candidate carries its value's link
#if SLAB_ABLATE == 8
          if (ABL != ABL_NOPUSH_LIVE && isdon && x.internal) {
#elif SLAB_ABLATE >= 12 && SLAB_ABLATE <= 14
          if (MODE != MODE_SCORE && isdon && x.internal) {   // no push
#else
          if (KEEP(ABL_NOPUSH) && isdon && x.internal) {
#endif
#pragma unroll
            for (int k = 0; k < NS; ++k) {
              const int fv = sv[k];
              bool elig = (k != 0 || mk == 0) && (x.psp & PSP_BIT[k]) == 0;
              const int gopk = k / 2 == 0 ? 0 : (k / 2 == 1 ? gop : lgop);
              const int gk = (mk == 0 || ((k - mk) & 1)) ? gopk : 0;
              if (k != mk && fv <= mx + gk) elig = false;
              if (elig) {
                const int xv = fv + sig5;
                int pos = 0;
#pragma unroll
                for (int l = 0; l < NCAND; ++l) pos += x.cv[l] >= xv;
#pragma unroll
                for (int l = NCAND - 1; l >= 1; --l)
                  if (l > pos) {
                    x.cv[l] = x.cv[l - 1]; x.cj[l] = x.cj[l - 1];
                    x.cd[l] = x.cd[l - 1]; x.c5[l] = x.c5[l - 1];
                    x.lkc[l] = x.lkc[l - 1];
                  }
#pragma unroll
                for (int l = 0; l < NCAND; ++l)
                  if (l == pos) {
                    x.cv[l] = xv; x.cj[l] = n; x.cd[l] = k; x.c5[l] = dinc5;
                    x.lkc[l] = lks[k];
                  }
              }
            }
          }
          // ---- masked commit and emissions; local mode restarts an
          // active cell at the zero floor
          const bool reset = MODES && local && active && mx <= 0;
          const int h_out = !active ? NEV : reset ? 0 : mx;
          const int f_out = active ? sv[2] : NEV;
          int f2_out = NEV;
          if (active) x.e1 = sv[1];
          if constexpr (DAGP) {
            f2_out = active ? sv[4] : NEV;
            if (active) x.e2 = sv[3];
            F2s[(tau & 1) * KL + v] = f2_out;
          }
          x.h1 = h_out;
          Hs[p3 * KL + v] = h_out;
          Fs[(tau & 1) * KL + v] = f_out;
          if constexpr (LINKS) {
            int* lk = x.lk_out;
            const int lkh = active ? lk_mx : 0;
            x.lkh1 = lkh;
            x.lke = lks[1];
            HLs[p3 * KL + v] = lkh;
            FLs[(tau & 1) * KL + v] = lks[2];
            if constexpr (DAGP) {
              x.lke2 = lks[3];
              F2Ls[(tau & 1) * KL + v] = lks[4];
            }
            if (i == L - 1) {
              lk[t] = lkh;                          // boundary H
              lk[(size_t)nb * T + t] = lks[2];      // boundary F
              if constexpr (DAGP)
                lk[(size_t)4 * nb * T + t] = lks[4];   // boundary F2
            }
            if (i == x.li) lk[(size_t)2 * nb * T + t] = lkh;   // final row
            const int rcl = x.m0 + lw + 1 + t - N;      // lane with n == N
            if (i == rcl) lk[(size_t)3 * nb * T + t] = lkh;
            else if (i == 0 && (rcl < 0 || rcl >= L))
              lk[(size_t)3 * nb * T + t] = 0;
          } else if constexpr (TRACE) {
            x.fl_out[(size_t)t * tstride] =
                active ? (unsigned char)(mk | (e_open << 3) | (f_open << 4)
                                         | (e2_open << 5) | (f2_open << 6)
                                         | (reset << 7))
                       : (unsigned char)255;
#pragma unroll
            for (int k = 0; k < NS; ++k)
              x.spj_out[(size_t)k * plane + (size_t)t * tstride] = jn[k];
          }
          if (KEEP(ABL_NOEMIT) && active) {
#if SLAB_ABLATE == 7 || SLAB_ABLATE == 15
            if (rowb && m == M)
              rowb[n] = ABL == ABL_NOCLOSE_LIVE || ABL == ABL_RECUR_PUSH
                            ? h_out ^ x.cv[NCAND - 1] ^ x.cj[NCAND - 1]
                                  ^ x.cd[NCAND - 1] ^ x.c5[NCAND - 1]
                            : h_out;
#else
            if (rowb && m == M) rowb[n] = h_out;
#endif
            if (rcb && n == N) rcb[m] = h_out;
            if (i == L - 1) {
              bh[n] = h_out;
              bf[n] = f_out;
              if (DAGP) bf2[n] = f2_out;
            }
          }
        }
      }
      if (++x.slot == R) x.slot = 0;
    };

#if SLAB_EMIT_ROWS
    // local mode's emission (K6), the timing build's form: at the end of
    // global step tau each thread stores the committed H of its lanes
    // (NEV where a cell was inactive, as the ring holds it) into row er
    // of ebuf; after the barrier that ends each EC steps, thread (j,
    // step) scans sub-slab j's L values of that step for the best and its
    // first lane, in four interleaved runs merged by (value descending,
    // lane ascending), stores them, and one more barrier lets the next
    // steps overwrite the rows.  The round's last part is scanned after
    // the loop.
    auto emit_scan = [&](const int c0, const int n) {
      for (int q = g; q < ksub * EC; q += nthr) {
        const int j = q / EC, st = q - j * EC;
        const int tau = c0 + st, ls = r * ksub + j, t = tau - 2 * j * L;
        if (st >= n || ls >= nslab || t < 0 || t >= T) continue;
        const int* h = ebuf + st * ES + j * L;
        int bv[4], bi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {          // L >= 3; NEV > INT_MIN
          bv[u] = u < L ? h[u] : -2147483647 - 1;
          bi[u] = u;
        }
        for (int c = 4; c < L; c += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u < L && h[c + u] > bv[u]) {
              bv[u] = h[c + u];
              bi[u] = c + u;
            }
#pragma unroll
        for (int u = 1; u < 4; ++u)
          if (bv[u] > bv[0] || (bv[u] == bv[0] && bi[u] < bi[0])) {
            bv[0] = bv[u];
            bi[0] = bi[u];
          }
        const size_t o = ((size_t)ls * T + t) * nb + ob;
        loc_v[o] = bv[0];
        loc_i[o] = bi[0];
      }
    };

    int p3 = 0;                              // tau mod 3
    int er = 0;                              // tau's emission row
    for (int tau = 0; tau < nstep; ++tau) {
#pragma unroll
      for (int p = 0; p < P; ++p) lane_step(ln[p], g + p * nthr, tau, p3);
      if constexpr (EMIT) {
        int* row = ebuf + er * ES;
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (g + p * nthr < KL) row[g + p * nthr] = ln[p].h1;
      }
      if (++p3 == 3) p3 = 0;
      const bool chunk = (tau + 1) % C == 0;
      if (chunk) {                  // chunk q is due at step q*C
        const int q = (tau + 1) / C;
        __pipeline_wait_prior(0);
        pack(q);
        issue(q + 1);
      }
      __syncthreads();
      if constexpr (EMIT)
        if (++er == EC) {
          emit_scan(tau + 1 - EC, EC);
          __syncthreads();          // the scan is done with the rows
          er = 0;
        }
      if (chunk) sync_rounds(tau + 1);
    }
    __pipeline_wait_prior(0);     // nothing lands in the next round's ring
    if constexpr (EMIT)
      if (er) emit_scan(nstep - er, er);
#else
    // local mode's emission (K6), in two levels.  At the end of global
    // step tau each thread holds the committed H of its lanes (NEV where
    // a cell was inactive, as the ring holds it), and each warp reduces
    // its lanes of each sub-slab j to a (best, first lane) partial, slot
    // warp + j of buffer tau & 1 (the slots of a warp's sub-slabs and of
    // a sub-slab's warps both rise with the lane, so no two partials
    // share one).  After the step's barrier, in step tau + 1, the thread
    // of sub-slab j's lane 0 combines its partials (value descending,
    // lane ascending: associative, so any order gives the first lane of
    // the best, jnp.argmax's rule) into loc_v / loc_i.  A step writes
    // one buffer while the other is read; the next write to a buffer
    // comes after the barrier that follows its combine.
    // The round's constants: the warp's threads of this thread's sub-slab
    // (P = 1: thread v runs lane v, so a warp straddles sub-slabs where a
    // boundary falls inside it; P = 2: one sub-slab, k = 1), the first
    // step of the sub-slab, and for its lane 0 the first of its partials'
    // slots, their count and its output at t = 0.
    const int warp = g >> 5, wl = g & 31;
    const int et0 = 2 * ln[0].j * L;          // global step of t = 0
    unsigned gm = 0;
    int es0 = 0, esn = 0;
    size_t eo = 0;
    if constexpr (EMIT) {
      const Lane& x = ln[0];
      const int cnt = min(32, nthr - (warp << 5));   // threads of the warp
      const unsigned wmask = cnt == 32 ? 0xffffffffu : (1u << cnt) - 1;
      const bool straddle =
          P == 1 && (warp << 5) / L != ((warp << 5) + cnt - 1) / L;
      gm = straddle ? __match_any_sync(wmask, x.j) : wmask;
      es0 = (P == 1 ? (x.j * L) >> 5 : 0) + x.j;
      esn = P == 1 ? ((x.j * L + L - 1) >> 5) - ((x.j * L) >> 5) + 1
                   : (nthr + 31) >> 5;
      eo = (size_t)x.ls * T * nb + ob;
    }
    auto emit_partials = [&](const int tau) {
      const Lane& x = ln[0];
      const int t = tau - et0;
      if (!x.live || t < 0 || t >= T) return;     // uniform over gm
      int bv = x.h1, bi = x.i;
#pragma unroll
      for (int p = 1; p < P; ++p)                 // a later lane: strict >
        if (ln[p].live && ln[p].h1 > bv) {
          bv = ln[p].h1;
          bi = ln[p].i;
        }
      const int best = __reduce_max_sync(gm, bv);
      int first = bi;
      if constexpr (P == 1) {
        // the group's threads hold consecutive lanes in order: the
        // lowest thread that holds the best holds its first lane
        if (wl != __ffs(__ballot_sync(gm, bv == best)) - 1) return;
      } else {
        first = __reduce_min_sync(gm, bv == best ? bi : L);
        if (wl != __ffs(gm) - 1) return;
      }
      int* lp = lpart + (tau & 1) * 2 * EMIT_SLOTS + warp + x.j;
      lp[0] = best;
      lp[EMIT_SLOTS] = first;
    };
    auto emit_combine = [&](const int tau) {
      const Lane& x = ln[0];                 // lane 0 of sub-slab x.j
      const int t = tau - et0;
      if (x.i != 0 || !x.live || t < 0 || t >= T) return;
      const int* lp = lpart + (tau & 1) * 2 * EMIT_SLOTS + es0;
      int bv = lp[0], bi = lp[EMIT_SLOTS];
      for (int w = 1; w < esn; ++w) {
        const int v = lp[w], i = lp[EMIT_SLOTS + w];
        if (v > bv || (v == bv && i < bi)) {
          bv = v;
          bi = i;
        }
      }
      loc_v[eo + (size_t)t * nb] = bv;
      loc_i[eo + (size_t)t * nb] = bi;
    };

    int p3 = 0;                              // tau mod 3
    for (int tau = 0; tau < nstep; ++tau) {
#pragma unroll
      for (int p = 0; p < P; ++p) lane_step(ln[p], g + p * nthr, tau, p3);
      if constexpr (EMIT) {
        if (tau > 0) emit_combine(tau - 1);
        emit_partials(tau);
      }
      if (++p3 == 3) p3 = 0;
      const bool chunk = (tau + 1) % C == 0;
      if (chunk) {                  // chunk q is due at step q*C
        const int q = (tau + 1) / C;
        __pipeline_wait_prior(0);
        pack(q);
        issue(q + 1);
      }
      __syncthreads();
      if (chunk) sync_rounds(tau + 1);
    }
    __pipeline_wait_prior(0);     // nothing lands in the next round's ring
    if constexpr (EMIT) emit_combine(nstep - 1);
#endif
    sync_rounds(nstep);
  }
}

// ---------------------------------------------------------------- K2e
// spliced_last_ends replaces the lastS end extraction of _fused_call
// (ops/dp_spliced_pallas.py:1122-1178), with the semantics of the host
// collect_batch_results (ops/dp_spliced_scan.py:938-1006): strict >
// between candidate groups, first maximum within a segment, empty
// segments skipped.  On the plane path it runs as the prologue of K3's
// launch (spliced_ends_tb_walk, below), as _fused_call runs the
// extraction and the walk in one program.
//
// What bounds it on the H100: latency.  It reads (N + M) ints a problem,
// a few hundred KB a bucket; at a CTA a problem it runs within 1 us of
// an empty kernel's launch up to 1,024 columns (PERF.md).
//
// Design: bucket_ends, a CTA of 8 warps a problem, one barrier.  One
// loop reads both segments, the final row's [max(n_first, 1), N) and
// the right column's [max(N - up, 1), M), so their loads overlap, 16
// bytes at a time: each segment splits into a scalar head up to its
// first 16-byte boundary, whole int4, and a scalar tail (the row strides
// Nmax + 1 and Mpad + 1 put the boundary anywhere; ends_partition in
// dp_spliced_cuda.py models which thread reads which index).  Every
// thread carries a (value, index) pair for each segment, merged by a
// shuffle butterfly and one exchange of the warps' pairs in shared
// memory; the segments stay two results (a row/column tie goes to the
// row, as the groups' order has it).
constexpr int ENDS_THREADS = 256;
constexpr int ENDS_WARPS = ENDS_THREADS / 32;

// The best of two (value, index) pairs of a segment: the other unless it
// is empty (index -1), and only if it is greater, or equal at a smaller
// index.  The rule is associative and commutative: any order of merging
// gives the segment's first maximum.
__device__ __forceinline__ void seg_take(int& v, int& i, int ov, int oi) {
  if (oi >= 0 && (i < 0 || ov > v || (ov == v && oi < i))) {
    v = ov;
    i = oi;
  }
}

// Segment [lo, hi) of the array at v: a scalar head [lo, a) up to the
// first 16-byte boundary, nv whole int4 from a, a scalar tail
// [a + 4 nv, hi).
struct EndsSeg {
  const int* v;
  int lo, a, nv, hi;
};

__device__ __forceinline__ EndsSeg ends_seg(const int* v, int lo, int hi) {
  EndsSeg s;
  s.v = v;
  s.lo = lo;
  s.hi = max(hi, lo);
  const int base = (int)((reinterpret_cast<uintptr_t>(v) >> 2) & 3);
  s.a = min(s.hi, lo + ((4 - ((base + lo) & 3)) & 3));
  s.nv = (s.hi - s.a) >> 2;
  return s;
}

// thread p's scalar reads of a segment: head index lo + p, tail index
// a + 4 nv + p (p < 3)
__device__ __forceinline__ void ends_edges(const EndsSeg& s, int p, int& bv,
                                           int& bi) {
  if (p < 3) {
    int k = s.lo + p;
    if (k < s.a) seg_take(bv, bi, s.v[k], k);
    k = s.a + 4 * s.nv + p;
    if (k < s.hi) seg_take(bv, bi, s.v[k], k);
  }
}

// int4 c of a segment's body: indices a + 4c .. a + 4c + 3
__device__ __forceinline__ void ends_vec(const EndsSeg& s, int c, int& bv,
                                         int& bi) {
  const int k = s.a + 4 * c;
  const int4 x = __ldg(reinterpret_cast<const int4*>(s.v + k));
  seg_take(bv, bi, x.x, k);
  seg_take(bv, bi, x.y, k + 1);
  seg_take(bv, bi, x.z, k + 2);
  seg_take(bv, bi, x.w, k + 3);
}

// (score, end m, end n) of problem b, by the ENDS_THREADS threads p of
// one CTA; every one of them calls it (it holds one __syncthreads).  The
// result is valid in warp 0, in every lane of it.  part: ENDS_WARPS x 4
// ints of shared memory.
__device__ __forceinline__ int3 bucket_ends(
    const int* __restrict__ row, const int* __restrict__ rc, int b, int p,
    int M, int N, int lw, int Np, int Mpad, int W, int gop, int gep,
    int a_exgl, int a_exgr, int b_exgl, int b_exgr, int (*part)[4]) {
  const int up = lw + W - 1;
  const int n_first = max(M + lw, 0);
  const int* rowb = row + (size_t)b * Np;
  const int* rcb = rc + (size_t)b * (Mpad + 1);
  const EndsSeg rs = a_exgr ? ends_seg(rowb, max(n_first, 1), N)
                            : ends_seg(rowb, 0, 0);
  const EndsSeg cs = b_exgr ? ends_seg(rcb, max(N - up, 1), M)
                            : ends_seg(rcb, 0, 0);
  int rv = 0, ri = -1, cv = 0, ci = -1;
  ends_edges(rs, p, rv, ri);
  ends_edges(cs, p, cv, ci);
  const int nv = max(rs.nv, cs.nv);
#pragma unroll 4
  for (int c = p; c < nv; c += ENDS_THREADS) {
    if (c < rs.nv) ends_vec(rs, c, rv, ri);
    if (c < cs.nv) ends_vec(cs, c, cv, ci);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int orv = __shfl_xor_sync(0xffffffffu, rv, o);
    const int ori = __shfl_xor_sync(0xffffffffu, ri, o);
    const int ocv = __shfl_xor_sync(0xffffffffu, cv, o);
    const int oci = __shfl_xor_sync(0xffffffffu, ci, o);
    seg_take(rv, ri, orv, ori);
    seg_take(cv, ci, ocv, oci);
  }
  if ((p & 31) == 0) {
    part[p >> 5][0] = rv;
    part[p >> 5][1] = ri;
    part[p >> 5][2] = cv;
    part[p >> 5][3] = ci;
  }
  __syncthreads();
  if (p < 32) {
#pragma unroll
    for (int w = 1; w < ENDS_WARPS; ++w) {
      seg_take(rv, ri, part[w][0], part[w][1]);
      seg_take(cv, ci, part[w][2], part[w][3]);
    }
  }
  // the candidate groups in collect_batch_results' order: H(M, N), the
  // a_exgr corner, the final row, the b_exgr corner, the right column
  int bv = rowb[N], bm = M, bn = N, v;
  if (a_exgr) {
    // stale band-edge / column-0 corner candidates come first
    if (lw >= -M) {
      v = colinit(-lw, b_exgl, gop, gep);
      if (v > bv) { bv = v; bm = M; bn = n_first; }
    } else if (n_first == 0) {
      v = colinit(M, b_exgl, gop, gep);
      if (v > bv) { bv = v; bm = M; bn = 0; }
    }
    if (ri >= 0 && rv > bv) { bv = rv; bm = M; bn = ri; }
  }
  if (b_exgr) {
    if (max(N - up, 0) == 0) {
      v = a_exgl ? 0 : gop + gep * N;
      if (v > bv) { bv = v; bm = 0; bn = N; }
    }
    if (ci >= 0 && cv > bv) { bv = cv; bm = ci; bn = N; }
  }
  return make_int3(bv, bm, bn);
}

// K2e alone: a CTA a problem
__global__ void __launch_bounds__(ENDS_THREADS)
last_ends_kernel(const int* __restrict__ row, const int* __restrict__ rc,
                 const int* __restrict__ Ms, const int* __restrict__ Ns,
                 const int* __restrict__ lws, int Np, int Mpad, int W,
                 int gop, int gep, int a_exgl, int a_exgr, int b_exgl,
                 int b_exgr, int* __restrict__ ends) {
  __shared__ int part[ENDS_WARPS][4];
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const int3 e = bucket_ends(row, rc, b, p, Ms[b], Ns[b], lws[b], Np, Mpad,
                             W, gop, gep, a_exgl, a_exgr, b_exgl, b_exgr,
                             part);
  if (p == 0) {
    ends[b * 3] = e.x;
    ends[b * 3 + 1] = e.y;
    ends[b * 3 + 2] = e.z;
  }
}

// ---------------------------------------------------------------- K3
// spliced_tb_walk replaces the device traceback walker _tb_walker
// (ops/dp_spliced_scan.py:1127-1196): from each problem's end cell it
// follows the winner state, gap-open bits and junction planes back to
// row or column 0, one (kind, m, n, jnc - 1) record per step.  Its strip
// mode (spliced_tb_strips) replaces the host strip walks of the UDH
// retrace (traceback_spliced_strip, dp_spliced_scan.py:1235): every
// (slab, problem) strip of one retrace launch's planes (slabs s0.., or
// in a retrace of pairs slab slab0[b] of column b), each
// from a given (m, n, state) in the planes of a given problem column b,
// stops once m <= m_stop, its slab's upper boundary, where the full walk
// stops at m < 1.  NS is the planes' state count (3, or 5 under DAGP:
// states 1 and 3 are horizontal, 2 and 4 vertical, _tb_walker
// 1137-1184).
//
// What bounds it on the H100: latency.  A walk is a chain of steps, each
// choosing its move from the flags and junction words of the cell the
// last step reached: read from global memory, one round trip a step
// (an L2 hit at best, an HBM read once the planes outgrow the L2).
//
// Design: one warp a walk (a CTA each, several to an SM).  The warp
// stages in shared memory, in one round trip, the cells a run of steps
// in the walk's state reaches from the step's cell (i, t): lane k reads
// the flags and every junction plane at (i - k, t - 2k) in state 0 (a
// diagonal run), (i, t - k) in a horizontal state, (i - k, t - k) in a
// vertical one, k < 32, within its slab's lanes and the planes' rows (a
// band, no wider: a staged rectangle of lanes x rows costs a 128-byte
// line a row and plane, one SM's misses queue behind each other, and
// most of the lines hold cells the walk never reads).  A step whose cell
// is off the band (a change of state, an intron close, a slab crossing,
// the band's end) stages the band from that cell in its state.  Every
// lane runs the same walk on the same values (shared-memory reads
// broadcast, no divergence).  A run of plain
// diagonal steps in state 0 (the bulk of a path) takes a loop of its own
// whose chain is two shared-memory reads and one test; the other steps
// take the full rule.  The walk's slab and lane follow m by a decrement,
// not a division.  Lane it % 32 keeps step it's record, and the warp
// writes each run of 32 records with one store.  tb_walk_tiles in
// dp_spliced_cuda.py models the loads.
constexpr int TB_CELLS = 32;                     // cells of a staged band
constexpr int TB_STEP_T = 2;                     // rows a diagonal step

// The walk w of nw by the 32 lanes of one warp (lane = threadIdx.x < 32;
// the warp syncs with __syncwarp alone): from cell (m, n) in state st
// down to row m_stop (exclusive) through the planes of problem column b,
// whose band starts at lw; band: the warp's staged band, (1 + 5) x
// TB_CELLS ints of shared memory (flags, then junction planes).
__device__ __forceinline__ void tb_walk_body(
    const unsigned char* __restrict__ flags, const int* __restrict__ spj,
    int w, int nw, int b, int m, int n, int st, int m_stop, int lw, int B,
    int L, int S, int T, int IT, int NS, int s0, int* __restrict__ recs,
    int* __restrict__ stats, int (*band)[TB_CELLS]) {
  const int lane = threadIdx.x;
  const size_t BL = (size_t)B * L, TBL = (size_t)T * BL;
  bool done = m <= m_stop || n < 1;
  // the walk's slab (relative to s0) and lane of row m, m >= 1 while it
  // runs
  int s = done ? 0 : (m - 1) / L - s0, i = done ? 0 : (m - 1) % L;
  // the band in force: slab bs, cells (bi - di k, bt - dt k), k < blen
  int bs = -1, bi = 0, bt = 0, di = 0, dt = 0, blen = 0, loads = 0;
  int4 held = make_int4(0, 0, 0, 0);
  int it = 0;
  // step it's record: lane it % 32 keeps it, the warp stores 32 at once
  auto emit = [&](int kind, int x) {
    if (lane == (it & 31)) held = make_int4(kind, m, n, x);
    if ((it & 31) == 31)
      reinterpret_cast<int4*>(recs)[(size_t)(it - 31 + lane) * nw + w] =
          held;
    ++it;
  };
  while (it < IT && !done) {
    const int t = (n - m) - lw - 1 + 2 * i;
    const bool ok = t >= 0 && t < T && s >= 0 && s < S;
    int fl = 255, jnc_s = 0, jnc_0 = 0;
    if (ok) {
      int k = di ? bi - i : bt - t;
      if (s != bs || (unsigned)k >= (unsigned)blen || i != bi - di * k
          || t != bt - dt * k) {
        bs = s;
        bi = i;
        bt = t;
        di = st == 1 || st == 3 ? 0 : 1;    // horizontal: the same lane
        dt = st == 0 ? TB_STEP_T : 1;
        blen = min(min(TB_CELLS, di ? i + 1 : TB_CELLS), t / dt + 1);
        k = 0;
        __syncwarp();                       // every lane is off the old band
        if (lane < blen) {
          const size_t c = (size_t)(t - dt * lane) * BL + b * L
                           + (i - di * lane);
          const int f = flags[s * TBL + c];
          int x[5];
#pragma unroll
          for (int q = 0; q < 5; ++q)
            if (q < NS) x[q] = spj[((size_t)s * NS + q) * TBL + c];
          band[0][lane] = f;
#pragma unroll
          for (int q = 0; q < 5; ++q)
            if (q < NS) band[1 + q][lane] = x[q];
        }
        __syncwarp();                       // the band is staged
        ++loads;
      }
      if (st == 0 && dt == TB_STEP_T) {
        // a run of plain diagonal steps (state 0, flags 0, no intron
        // close) along a diagonal band
        for (;;) {
          if (((band[0][k] & 0x87) | band[1][k]) != 0) break;
          emit(1, -1);
          --m;
          --n;
          ++k;
          if (--i < 0) {                    // the slab above: a new band
            i = L - 1;
            --s;
          }
          done = m <= m_stop || n < 1;
          if (done || it >= IT || k >= blen || s != bs) break;
        }
        if (done || it >= IT || k >= blen || s != bs) continue;
      }
      const int stc = min(max(st, 0), NS - 1);
      fl = band[0][k];
      jnc_s = band[1 + stc][k];
      jnc_0 = band[1][k];
    }
    const int hd = fl & 7;
    const bool is0 = st == 0;
    const bool dead = is0 && (fl == 255 || (fl & 0x80) || hd > 4);
    const bool i_close0 = is0 && !dead && hd == 0 && jnc_0 > 0;
    const bool diag = is0 && !dead && hd == 0 && jnc_0 == 0;
    const bool trans = is0 && !dead && hd > 0 && hd <= 4;
    const bool gsel = !is0;
    const bool i_close_g = gsel && jnc_s > 0;
    const bool horiz = gsel && jnc_s == 0 && (st == 1 || st == 3);
    const bool vert = gsel && jnc_s == 0 && (st == 2 || st == 4);
    const int obit = st == 1 ? 8 : st == 2 ? 16 : st == 3 ? 32
                   : st == 4 ? 64 : 0;
    const bool opened = (fl & obit) != 0;
    const bool i_close = i_close0 || i_close_g;
    const int jncv = is0 ? jnc_0 : jnc_s;
    emit((!ok || dead || trans) ? 0 : i_close ? 4 : diag ? 1 : horiz ? 2 : 3,
         jncv - 1);
    const int n2 = i_close ? jncv - 1 : ((diag || horiz) ? n - 1 : n);
    st = trans ? hd : (((horiz || vert) && opened) ? 0 : st);
    if (diag || vert) {                     // row m - 1: the lane above
      --m;
      if (--i < 0) {
        i = L - 1;
        --s;
      }
    }
    done = dead || !ok || m <= m_stop || n2 < 1;
    n = n2;
  }
  const int pend = it & 31;                 // records not yet written
  if (lane < pend)
    reinterpret_cast<int4*>(recs)[(size_t)(it - pend + lane) * nw + w] = held;
  if (stats && lane == 0) {
    stats[w * 2] = it;
    stats[w * 2 + 1] = loads;
  }
}

__global__ void __launch_bounds__(32)
tb_walk_kernel(const unsigned char* __restrict__ flags,
               const int* __restrict__ spj, const int* __restrict__ ends,
               const int* __restrict__ starts, const int* __restrict__ lws,
               int nw, int B, int L, int S, int T, int IT, int NS, int s0,
               const int* __restrict__ slab0, int* __restrict__ recs,
               int* __restrict__ stats) {
  __shared__ int band[1 + 5][TB_CELLS];     // flags, then junction planes
  const int w = blockIdx.x;
  int b, m, n, st, m_stop;
  if (starts) {             // (m, n, state, m_stop, problem column)
    const int* x = starts + (size_t)w * 5;
    m = x[0]; n = x[1]; st = x[2]; m_stop = x[3]; b = x[4];
  } else {
    b = w;
    m = ends[b * 3 + 1]; n = ends[b * 3 + 2]; st = 0; m_stop = 0;
  }
  // the planes of column b start at slab slab0[b] (a retrace of pairs),
  // or all at s0
  tb_walk_body(flags, spj, w, nw, b, m, n, st, m_stop, lws[b], B, L, S, T,
               IT, NS, slab0 ? slab0[b] : s0, recs, stats, band);
}

// spliced_ends_tb_walk: K2e as the prologue of K3's launch on the plane
// path (the reference's own fusion, _fused_call).  A CTA of ENDS_THREADS
// a problem: its 8 warps find the ends (bucket_ends, one barrier),
// thread 0 writes them to ends and to shared memory, warps 1-7 return
// and warp 0 walks from them with K3's body.  No __syncthreads may
// follow the ends' barrier: the walk syncs with __syncwarp alone.
__global__ void __launch_bounds__(ENDS_THREADS)
ends_tb_walk_kernel(const unsigned char* __restrict__ flags,
                    const int* __restrict__ spj, const int* __restrict__ row,
                    const int* __restrict__ rc, const int* __restrict__ Ms,
                    const int* __restrict__ Ns, const int* __restrict__ lws,
                    int B, int L, int S, int T, int IT, int NS, int Np,
                    int Mpad, int W, int gop, int gep, int a_exgl,
                    int a_exgr, int b_exgl, int b_exgr,
                    int* __restrict__ ends, int* __restrict__ recs,
                    int* __restrict__ stats) {
  __shared__ int band[1 + 5][TB_CELLS];     // flags, then junction planes
  __shared__ int part[ENDS_WARPS][4];       // the warps' (row, rc) pairs
  __shared__ int start[2];                  // the walk's (m, n)
  const int b = blockIdx.x;
  const int lw = lws[b];
  const int3 e = bucket_ends(row, rc, b, threadIdx.x, Ms[b], Ns[b], lw, Np,
                             Mpad, W, gop, gep, a_exgl, a_exgr, b_exgl,
                             b_exgr, part);
  if (threadIdx.x >= 32) return;
  if (threadIdx.x == 0) {
    ends[b * 3] = e.x;
    ends[b * 3 + 1] = e.y;
    ends[b * 3 + 2] = e.z;
    start[0] = e.y;
    start[1] = e.z;
  }
  // the walk starts from the ends read back from shared memory, not
  // from the shuffled registers: values loaded from one address are
  // warp-uniform to the compiler, so the walk's state and branches stay
  // uniform as in tb_walk_kernel (from the registers it ran 25-30% slower)
  __syncwarp();
  const int m0 = start[0], n0 = start[1];
  tb_walk_body(flags, spj, b, B, b, m0, n0, 0, 0, lw, B, L, S, T, IT, NS,
               0, recs, stats, band);
}

int tb_walk_entry(const unsigned char* flags, const int* spj,
                  const int* ends, const int* starts, const int* lws, int nw,
                  int B, int L, int S, int T, int IT, int NS, int s0,
                  const int* slab0, int* recs, int* stats,
                  cudaStream_t stream) {
  if (nw <= 0) return 0;
  if (NS != 3 && NS != 5) return (int)cudaErrorInvalidValue;
  tb_walk_kernel<<<nw, 32, 0, stream>>>(flags, spj, ends, starts, lws, nw,
                                        B, L, S, T, IT, NS, s0, slab0, recs,
                                        stats);
  return (int)cudaGetLastError();
}

// One launch of the slab kernel: nb CTAs of k sub-slabs of L lanes,
// ceil(k*L / P) threads of P = ceil(k*L / MAXT) lanes each, and smem
// bytes of dynamic shared memory, as slab_geometry chose them.  A launch
// the instance cannot take is refused with cudaErrorInvalidValue;
// nothing is launched with other numbers.
template <int MODE, bool DAGP, int P, int K6>
auto slab_instance(int ncta) {
  constexpr int MAXT = max_threads(MODE, DAGP);
  return ncta > 1 ? slab_kernel<MODE, DAGP, true, MAXT, P, K6>
                  : slab_kernel<MODE, DAGP, false, MAXT, P, K6>;
}

// The instance of a launch: P lanes a thread, K6's modes (K6_MODES, or
// K6_EMIT with the local emission) or not (K6_OFF; the score mode has
// no other)
template <int MODE, bool DAGP, int K6>
auto slab_pick(int P, int ncta) {
  return P == 1 ? slab_instance<MODE, DAGP, 1, K6>(ncta)
                : slab_instance<MODE, DAGP, 2, K6>(ncta);
}

// The retrace of pairs' instance: a CTA a pair (no cluster), P lanes a
// thread
template <bool DAGP>
auto pairs_pick(int P) {
  constexpr int MAXT = max_threads(MODE_TRACE, DAGP);
  return P == 1 ? slab_kernel<MODE_TRACE, DAGP, false, MAXT, 1, K6_PAIRS>
                : slab_kernel<MODE_TRACE, DAGP, false, MAXT, 2, K6_PAIRS>;
}

template <int MODE, bool DAGP>
int launch_slab(const int* qprof, const int* gops, const int* joint,
                const int* ipen, const int* Ms, const int* Ns,
                const int* lws, const int* sel, const int* slabs, int nb,
                int L, int A, int s0, int nslab, int k, int smem, int ncta,
                int* prog,
                int W, int T, int Mpad, int Np, int gop, int gep, int lgop,
                int lgep, int llmt, int a_exgl, int a_exgr, int b_exgl,
                const int* snap, int* bnd, unsigned char* flags, int* spj,
                int* row, int* rc, int* links, int* snaps,
                const int* cip, int local, int* loc_v, int* loc_i,
                cudaStream_t stream) {
#if SLAB_ABLATE
  // a knock-out build times the score mode alone: no other mode's kernel
  // is instantiated, and their entries refuse
  if constexpr (MODE != MODE_SCORE) {
    return (int)cudaErrorNotSupported;
  } else {
#endif
  constexpr int MAXT = max_threads(MODE, DAGP);
  const int KL = k * L;
  const int P = (KL + MAXT - 1) / MAXT;      // lanes a thread
  const int nthr = (KL + P - 1) / P;
  if (k < 1 || P > LANES_PER_THREAD || (P > 1 && k > 1) || A > 256
      || ncta < 1 || ncta > CLUSTER_MAX
      || smem < 4 * (slab_smem_ints(KL, A, MODE, DAGP)
                     + (loc_v ? (SLAB_EMIT_ROWS ? KL | 1 : EMIT_INTS) : 0))
      || (loc_v && (nthr + 31) / 32 + k > EMIT_SLOTS))
    return (int)cudaErrorInvalidValue;
  const bool k6 = cip || local || loc_v;
  auto kernel = slab_pick<MODE, DAGP, K6_OFF>(P, ncta);
  if constexpr (MODE == MODE_SCORE) {
    if (k6 || slabs) return (int)cudaErrorInvalidValue;
  } else if constexpr (MODE == MODE_TRACE) {
    if (slabs && (k6 || nslab != 1 || ncta != 1))
      return (int)cudaErrorInvalidValue;
    if (slabs) kernel = pairs_pick<DAGP>(P);
    if (loc_v) kernel = slab_pick<MODE, DAGP, K6_EMIT>(P, ncta);
    else if (k6) kernel = slab_pick<MODE, DAGP, K6_MODES>(P, ncta);
  } else {
    if (slabs) return (int)cudaErrorInvalidValue;
    if (loc_v) return (int)cudaErrorInvalidValue;
    if (k6) kernel = slab_pick<MODE, DAGP, K6_MODES>(P, ncta);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(nb * ncta);
  cfg.blockDim = dim3(nthr);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (ncta > 1) {                   // the CTAs of a problem, together
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, qprof, gops, joint, ipen, Ms, Ns, lws, sel, slabs, A, L,
      s0, nslab, W, T, Mpad, Np, gop, gep, lgop, lgep, llmt, a_exgl, a_exgr,
      b_exgl, snap, bnd, flags, spj, row, rc, links, snaps, ncta, prog, cip,
      local, loc_v, loc_i);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
#if SLAB_ABLATE
  }
#endif
}

}  // namespace

// Entries of the slab kernel take the operands, the geometry and the
// scores in one order: (qprof, gops, joint, ipen, Ms, Ns, lws, B, L, A,
// S, k, smem, ncta, prog, W, T, Mpad, Np, gop, gep, lgop, lgep, llmt,
// a_exgl, a_exgr, b_exgl); the retrace entries take (sel, nb, L, A, s0,
// nslab, k, smem, ncta, prog, W, ...) in place of (B, L, A, S, k, smem,
// ncta, prog, W, ...), the retrace-pairs entries (sel, slabs, nb, L, A,
// k, smem, ncta, prog, W, ...).  k (sub-slabs) and smem (bytes) come from
// slab_geometry, ncta (CTAs per problem) from slab_ctas; prog is scratch
// of nb * ceil(S / k) ints.  lgop/lgep are read by the DAGP
// instantiations only.
#define SLAB_ARGS                                                         \
  const int *qprof, const int *gops, const int *joint, const int *ipen,   \
      const int *Ms, const int *Ns, const int *lws
#define SCORE_ARGS                                                        \
  int W, int T, int Mpad, int Np, int gop, int gep, int lgop, int lgep,   \
      int llmt, int a_exgl, int a_exgr, int b_exgl
#define GEOM_ARGS int k, int smem, int ncta, int* prog
#define PASS_SCORE                                                        \
  W, T, Mpad, Np, gop, gep, lgop, lgep, llmt, a_exgl, a_exgr, b_exgl
// K6's modes of K1 and K4 (after their outputs): the -yJ bonus (B, Mpad
// + L), or null, and the local switch; K1 then takes the local mode's
// emission (loc_v, loc_i), or nulls
#define MODE_ARGS const int *cip, int local

extern "C" {

const char* spliced_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int spliced_slab_trace(SLAB_ARGS, int B, int L, int A, int S, GEOM_ARGS,
                       SCORE_ARGS, int* bnd, unsigned char* flags, int* spj,
                       int* row, int* rc, MODE_ARGS, int* loc_v, int* loc_i,
                       cudaStream_t stream) {
  return launch_slab<MODE_TRACE, false>(
      qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0, S,
      k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, flags, spj, row, rc,
      nullptr, nullptr, cip, local, loc_v, loc_i, stream);
}

int spliced_slab_trace_dagp(SLAB_ARGS, int B, int L, int A, int S,
                            GEOM_ARGS, SCORE_ARGS, int* bnd,
                            unsigned char* flags, int* spj, int* row,
                            int* rc, MODE_ARGS, int* loc_v, int* loc_i,
                            cudaStream_t stream) {
  return launch_slab<MODE_TRACE, true>(
      qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0, S,
      k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, flags, spj, row, rc,
      nullptr, nullptr, cip, local, loc_v, loc_i, stream);
}

int spliced_slab_retrace(SLAB_ARGS, const int* sel, int nb, int L, int A,
                         int s0, int nslab, GEOM_ARGS, SCORE_ARGS,
                         const int* snap, int* bnd, unsigned char* flags,
                         int* spj, cudaStream_t stream) {
  return launch_slab<MODE_TRACE, false>(
      qprof, gops, joint, ipen, Ms, Ns, lws, sel, nullptr, nb, L, A, s0, nslab,
      k, smem, ncta, prog, PASS_SCORE, snap, bnd, flags, spj, nullptr, nullptr,
      nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
}

int spliced_slab_retrace_dagp(SLAB_ARGS, const int* sel, int nb, int L,
                              int A, int s0, int nslab, GEOM_ARGS,
                              SCORE_ARGS, const int* snap, int* bnd,
                              unsigned char* flags, int* spj,
                              cudaStream_t stream) {
  return launch_slab<MODE_TRACE, true>(
      qprof, gops, joint, ipen, Ms, Ns, lws, sel, nullptr, nb, L, A, s0, nslab,
      k, smem, ncta, prog, PASS_SCORE, snap, bnd, flags, spj, nullptr, nullptr,
      nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
}

// The retrace of (problem, slab) pairs: CTA j runs slab slabs[j] of
// problem sel[j] alone (nslab = 1), from snap[:, j] (K4's snapshot of
// that slab); flags (1, T, nb, L), spj (1, NS, T, nb, L).
int spliced_slab_retrace_pairs(SLAB_ARGS, const int* sel, const int* slabs,
                               int nb, int L, int A, GEOM_ARGS, SCORE_ARGS,
                               const int* snap, int* bnd,
                               unsigned char* flags, int* spj,
                               cudaStream_t stream) {
  return launch_slab<MODE_TRACE, false>(
      qprof, gops, joint, ipen, Ms, Ns, lws, sel, slabs, nb, L, A, 0, 1, k,
      smem, ncta, prog, PASS_SCORE, snap, bnd, flags, spj, nullptr, nullptr,
      nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
}

int spliced_slab_retrace_pairs_dagp(SLAB_ARGS, const int* sel,
                                    const int* slabs, int nb, int L, int A,
                                    GEOM_ARGS, SCORE_ARGS, const int* snap,
                                    int* bnd, unsigned char* flags, int* spj,
                                    cudaStream_t stream) {
  return launch_slab<MODE_TRACE, true>(
      qprof, gops, joint, ipen, Ms, Ns, lws, sel, slabs, nb, L, A, 0, 1, k,
      smem, ncta, prog, PASS_SCORE, snap, bnd, flags, spj, nullptr, nullptr,
      nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
}

// CTAs of the retrace-pairs instance (a CTA a pair, P lanes a thread)
// an SM holds at once with ``threads`` threads and ``smem``
// bytes: cudaOccupancyMaxActiveBlocksPerMultiprocessor into *blocks.
int spliced_retrace_pairs_occupancy(int dagp, int P, int threads, int smem,
                                    int* blocks) {
#if SLAB_ABLATE
  return (int)cudaErrorNotSupported;       // the score mode alone
#else
  auto kernel = dagp ? pairs_pick<true>(P) : pairs_pick<false>(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
#endif
}

int spliced_slab_links(SLAB_ARGS, int B, int L, int A, int S, GEOM_ARGS,
                       SCORE_ARGS, int* bnd, int* row, int* rc, int* links,
                       int* snaps, MODE_ARGS, cudaStream_t stream) {
  return launch_slab<MODE_LINKS, false>(
      qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0, S,
      k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, nullptr, nullptr, row, rc,
      links, snaps, cip, local, nullptr, nullptr, stream);
}

int spliced_slab_links_dagp(SLAB_ARGS, int B, int L, int A, int S,
                            GEOM_ARGS, SCORE_ARGS, int* bnd, int* row,
                            int* rc, int* links, int* snaps, MODE_ARGS,
                            cudaStream_t stream) {
  return launch_slab<MODE_LINKS, true>(
      qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0, S,
      k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, nullptr, nullptr, row, rc,
      links, snaps, cip, local, nullptr, nullptr, stream);
}

int spliced_slab_score(SLAB_ARGS, int B, int L, int A, int S, GEOM_ARGS,
                       SCORE_ARGS, int dagp, int* bnd, int* row, int* rc,
                       cudaStream_t stream) {
  if (dagp)
    return launch_slab<MODE_SCORE, true>(
        qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0,
        S, k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, nullptr, nullptr,
        row, rc, nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
  return launch_slab<MODE_SCORE, false>(
      qprof, gops, joint, ipen, Ms, Ns, lws, nullptr, nullptr, B, L, A, 0, S,
      k, smem, ncta, prog, PASS_SCORE, nullptr, bnd, nullptr, nullptr, row, rc,
      nullptr, nullptr, nullptr, 0, nullptr, nullptr, stream);
}

int spliced_last_ends(const int* row, const int* rc, const int* Ms,
                      const int* Ns, const int* lws, int B, int Np,
                      int Mpad, int W, int gop, int gep, int a_exgl,
                      int a_exgr, int b_exgl, int b_exgr, int* ends,
                      cudaStream_t stream) {
  if (B <= 0) return 0;
  last_ends_kernel<<<B, ENDS_THREADS, 0, stream>>>(
      row, rc, Ms, Ns, lws, Np, Mpad, W, gop, gep, a_exgl, a_exgr, b_exgl,
      b_exgr, ends);
  return (int)cudaGetLastError();
}

// K2e + K3 in one launch (the plane path): ends (B, 3) and the walks'
// records and stats as spliced_last_ends and spliced_tb_walk give them
int spliced_ends_tb_walk(const unsigned char* flags, const int* spj,
                         const int* row, const int* rc, const int* Ms,
                         const int* Ns, const int* lws, int B, int L, int S,
                         int T, int IT, int NS, int Np, int Mpad, int W,
                         int gop, int gep, int a_exgl, int a_exgr,
                         int b_exgl, int b_exgr, int* ends, int* recs,
                         int* stats, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (NS != 3 && NS != 5) return (int)cudaErrorInvalidValue;
  ends_tb_walk_kernel<<<B, ENDS_THREADS, 0, stream>>>(
      flags, spj, row, rc, Ms, Ns, lws, B, L, S, T, IT, NS, Np, Mpad, W, gop,
      gep, a_exgl, a_exgr, b_exgl, b_exgr, ends, recs, stats);
  return (int)cudaGetLastError();
}

int spliced_tb_walk(const unsigned char* flags, const int* spj,
                    const int* ends, const int* lws, int B, int L, int S,
                    int T, int IT, int NS, int* recs, int* stats,
                    cudaStream_t stream) {
  return tb_walk_entry(flags, spj, ends, nullptr, lws, B, B, L, S, T, IT, NS,
                       0, nullptr, recs, stats, stream);
}

// slab0 (B,): the first slab of each problem column's planes (the
// retrace of pairs: its slab), or null for s0 in every column
int spliced_tb_strips(const unsigned char* flags, const int* spj,
                      const int* starts, const int* lws, int nw, int B,
                      int L, int S, int T, int IT, int NS, int s0,
                      const int* slab0, int* recs, int* stats,
                      cudaStream_t stream) {
  return tb_walk_entry(flags, spj, nullptr, starts, lws, nw, B, L, S, T, IT,
                       NS, s0, slab0, recs, stats, stream);
}

}  // extern "C"
