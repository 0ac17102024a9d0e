// Protein x translated-genome spliced DP (the tron path) on an NVIDIA
// Hopper GPU: the wavefront forward K7 (a template over the
// double-affine switch) and the traceback walk K8, behind three entries
// of a plain C interface (bound with ctypes by
// spaln_tpu_torch/ops/dp_tron_cuda.py, which also holds their plain
// PyTorch versions).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libtron_dp.so tron_dp.cu
//
// K7 replaces spaln_tpu's _tron_scan_batch step and its slab loop
// (spaln_tpu/ops/dp_tron_scan.py:116-629, _tron_fused 820 and
// run_tron_batch 845-946), a lax.scan over (B, L) vectors; K8 replaces
// _tron_tb_walker (1113-1206).  All arithmetic is int32 x10 fixed point
// in the scan step's operation order, which fixes every tie-break, so
// results equal the reference's exactly.
//
// K7's recurrence.  Lane i of slab s (aa row m = m0 + i, m0 = s L + 1)
// at its local step t computes n = c0 - 3i + t, c0 = 3 m0 + lw - 1; it
// reads lane i-1 at t-3..t-6 (vertical, 2/1-nt slides, codon diagonal)
// and itself at t-1..t-3 (the E queue) from an 8-step ring in shared
// memory, one barrier a step.  Lane 0 reads the previous slab's last row
// from the boundary rows in global memory (by column n), which lane L-1
// rewrites in place for its active cells, 3(L-1) nt behind lane 0's
// reads (so L >= 3).  Per lane the state is in registers: the three
// 3-frame E queues, the three per-phase donor lists of 4 candidates
// (value, donor position, state, dinucleotide pair: 48 ints) and sliding
// windows of the genome operands at n-2..n+1.
//
// What bounds it on the H100: the step's latency (a serial chain of some
// 400 integer selects between two barriers) times the critical path in
// steps; the planes (6 bytes a state a cell) are the only traffic of
// size.  Run in the slabs' order, one slab after another, the critical
// path is S T steps (T = W + 6(L-1)) on one SM a problem.
//
// The design shortens the path by running a problem's slabs at once.
// In the frame where lane i of slab s is at t = tau - 6 s L, every lane
// of the problem computes n = 3 + lw - 1 - 3(sL + i) + tau: slab s+1's
// lane 0 at tau reads the column that slab s's lane L-1 wrote at tau-3
// (a write of an earlier slab to a column always lands 3 or more steps
// before lane 0 of a later slab reads it, and a later slab or lane L-1
// of the same slab writes it only 3L-6 or more steps after the read).
// So any schedule that runs the frame's steps in order, each step after
// the writes of the step three before it, gives the slabs' sequential
// values: the stale band-edge columns of the boundary row included.
//   * A CTA runs a round of k units (slabs) in lockstep, unit j at
//     local step tau - 6 j L: one barrier a global step; a round of k'
//     slabs takes T + 6(k'-1)L steps.  Lane 0 of every unit still reads
//     the boundary row in global memory (the stale columns are part of
//     the result), 3 steps after the unit above wrote it.
//   * A problem's rounds run on a cluster of ncta CTAs: CTA q runs
//     rounds q, q + ncta, ...  Every STAGE steps a round publishes the
//     steps it has done (a release store after the barrier); round r+1
//     waits (an acquire load) until round r is 6 L (s' - s) + STAGE steps
//     ahead of it or done, s and s' the first slabs of the two rounds.
//     Then its reads follow the writes they need and precede the writes
//     they must not see, as in one CTA; the boundary rows go through L2
//     there (__ldcg).  The cluster keeps a problem's CTAs on the card
//     together, so the waits cannot deadlock.
//   * A slab wider than the instance's thread budget (max_threads) is
//     cut into np pieces of PL <= budget lanes, one piece a round.  A
//     piece boundary is no slab boundary: lane 0 of piece p reads lane
//     PL-1 of piece p-1 exactly as a ring neighbour (every step, NEV for
//     an inactive cell), through a step-indexed row in global memory
//     (pb), and the pieces of a slab share its local steps, so round r+1
//     need only be STAGE steps behind round r.
//   * The best LocalR end: each CTA reduces its threads' running bests,
//     then CTA 0 of the cluster reduces the CTAs' (value desc, m asc, n
//     asc): a total order, so the result does not depend on which CTA
//     finishes first.
// Serial steps of a launch (tron_serial_steps in dp_tron_cuda.py, the
// same model): one CTA, ceil(S/k) rounds one after another, about
// S T + 6(k-1)L ceil(S/k); on a cluster of ceil(S/k) CTAs about
// T + 6(S-1)L plus up to 2 STAGE per round for the publications.
//
// K8: a warp a problem walks its planes from its end cell back to the
// matrix edge (5 states, per-phase junction closes, split codons) on
// tiles of the planes staged in shared memory.
//
// Layouts (row-major):
//   gen   (B, 4, Nmax)            code word (btron | dinc5 << 5 | dinc3
//                                 << 9 | (phs5+2) << 13 | (phs3+2) <<
//                                 16), sigE, sig5, sig3 - tab3[dinc3]
//   aa    (B, Mpad + 1)           a[min(j, M-1)]
//   meta  (B, 5)                  M, N, lw, Local bounds lo, hi
//   tabs  (26*26 + 768 + P,)      tron matrix, tab53, junction-codon
//                                 tables t1, t2, intron penalty by length
//   bnd   (5, B, Nmax + 2)        boundary rows by n: H, dir, F, F2, its
//                                 dir (the last two under DAGP only): the
//                                 init row on entry
//   pb    (B, S, np-1, 5, T)      piece rows by step: H, dir, F, F2, its
//                                 dir of lane PL-1 of each piece but the
//                                 last (np > 1 only)
//   prog  (B, rounds)             steps each round has done, zero on entry
//   lbest (B, ncta, 3)            each CTA's best LocalR end (ncta > 1)
//   fl    (B, S, T, NN, L) u8     H: dir | winner << 5 (255 inactive);
//                                 E, F, E2, F2: dir | 0x80 if opened
//   spj   (B, S, T, NN, L) int32  1 + donor position of an intron closed
//                                 into state k; php the same, int8 phase
//   row   (B, Nmax + 2)           H(M, n); rc (B, Mpad + 2) H(m, N)
//   loc   (B, 3)                  best LocalR end (value, m, n)
//   recs  (B, IT, 5)              K8 records (kind, m, n, a1, a2)
//   stats (B, 2)                  K8: each walk's steps and tile loads,
//                                 or null
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEV = -939524096;        // NEVSEL, cmn.h:79
constexpr int NCAND = 4;
constexpr int A_TRON = 26;
constexpr int T_T53 = A_TRON * A_TRON, T_T1 = T_T53 + 256,
              T_T2 = T_T53 + 512, T_IPEN = T_T53 + 768;
constexpr int DEAD = 0, RSRV = 1, DIAG = 2, NEWD = 3, VERT = 4, SLA1 = 5,
              SLA2 = 6, VERL = 7, HORI = 8, HOR1 = 9, HOR2 = 10, HORL = 11,
              SPIN = 16;
constexpr int RING = 8;                 // steps of history in the ring

// Geometry of K7; tron_geometry in ops/dp_tron_cuda.py holds the same
// numbers and picks k and the CTAs from them.
//   max_threads: the __launch_bounds__ of each instance, from its
//     registers (nvcc -Xptxas -v) so that none spills: k L threads a
//     CTA, or one piece of a wider slab;
//   STAGE: steps between two publications of a round's progress;
//   CLUSTER_MAX: CTAs per problem at most (a portable cluster).
constexpr int STAGE = 64;
constexpr int CLUSTER_MAX = 8;

constexpr int max_threads(bool dagp) { return dagp ? 256 : 384; }

__host__ __device__ inline int tron_smem_ints(int KL, bool dagp) {
  return T_IPEN + (dagp ? 5 : 3) * RING * KL;    // tables, rings
}

struct TronArgs {
  int B, L, S, T, W, Nmax, Mpad, P, local_l, local_r, a_exgr;
  int gop, gep, ge1, ge2, gw1, gw2, gw3, minl, lgop, lgep, gw3l;
  int k, ncta, np, PL;   // units a CTA, CTAs a problem, pieces, their lanes
};

__device__ __forceinline__ int ld(const int* a, int idx, int n, int fill) {
  return (unsigned)idx < (unsigned)n ? __ldg(a + idx) : fill;
}

__device__ __forceinline__ bool isvert(int d) {
  const int dm = d & 15;
  return dm >= VERT && dm <= VERL;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// (v, m, n) beats (bv, bm, bn): larger value, then smaller m, then n
__device__ __forceinline__ bool better(int v, int m, int n, int bv, int bm,
                                       int bn) {
  return v > bv || (v == bv && (m < bm || (m == bm && n < bn)));
}

// K7.  One CTA of k units of PL lanes (PL = L, or a piece of a wider
// slab with k = 1), one thread a lane; ncta CTAs a problem (MULTI).
template <bool DAGP, bool MULTI>
__global__ void __launch_bounds__(max_threads(DAGP))
    tron_forward_kernel(const int* __restrict__ gen,
                        const int* __restrict__ aa,
                        const int* __restrict__ meta,
                        const int* __restrict__ tabs, int* bnd, int* pb,
                        int* prog, int* lbest,
                        unsigned char* __restrict__ fl,
                        int* __restrict__ spj, signed char* __restrict__ php,
                        int* __restrict__ row, int* __restrict__ rc,
                        int* __restrict__ loc, TronArgs p) {
  constexpr int NN = DAGP ? 5 : 3;
  extern __shared__ int sm[];
  const int L = p.L, KL = blockDim.x, PL = p.PL, np = p.np;
  int* s_tab = sm;                                   // T_IPEN ints
  int* rH = sm + T_IPEN;                             // RING x KL each
  int* rD = rH + RING * KL;
  int* rF = rD + RING * KL;
  int* rF2 = rF + RING * KL;
  int* rF2D = rF2 + RING * KL;
  const int* s_mtx = s_tab;
  const int* s_t53 = s_tab + T_T53;
  const int* s_t1 = s_tab + T_T1;
  const int* s_t2 = s_tab + T_T2;
  const int* ipen = tabs + T_IPEN;
  const int ncta = MULTI ? p.ncta : 1;
  const int b = blockIdx.x / ncta, cq = blockIdx.x - b * ncta;
  const int g = threadIdx.x;
  const int j = g / PL, w = g - j * PL;   // unit of the round, its lane
  for (int x = g; x < T_IPEN; x += KL) s_tab[x] = tabs[x];
  const int M = meta[b * 5], N = meta[b * 5 + 1], lw = meta[b * 5 + 2];
  const int loc_lo = meta[b * 5 + 3], loc_hi = meta[b * 5 + 4];
  const int W = p.W, T = p.T, S = p.S, Np2 = p.Nmax + 2;
  const int* g_code = gen + (size_t)(b * 4 + 0) * p.Nmax;
  const int* g_sigE = gen + (size_t)(b * 4 + 1) * p.Nmax;
  const int* g_sig5 = gen + (size_t)(b * 4 + 2) * p.Nmax;
  const int* g_accb = gen + (size_t)(b * 4 + 3) * p.Nmax;
  const size_t bstride = (size_t)p.B * Np2;
  int* bH = bnd + (size_t)b * Np2;
  int* bHD = bH + bstride;
  int* bF = bHD + bstride;
  int* bF2 = bF + bstride;
  int* bF2D = bF2 + bstride;
  // rows other SMs write go through L2 (MULTI), else through L1
  auto ldg = [](const int* q) {
    if constexpr (MULTI) return __ldcg(q);
    else return *q;
  };
  const int gopk[5] = {0, 0, p.gop, p.gop, p.lgop};
  const int sdnew[5] = {DIAG | SPIN, HORI | SPIN, VERT | SPIN, HORL | SPIN,
                        VERL | SPIN};
  const int nunit = S * np, nround = (nunit + p.k - 1) / p.k;
  const int L6 = 6 * L;
  int* prog_b = prog + (size_t)b * nround;
  int lv = NEV, lm = 0, ln = 0;                     // best LocalR end

  for (int r = cq; r < nround; r += ncta) {
    const int u0 = r * p.k;                        // first unit, slab
    const int sf = u0 / np;
    const int nstep = T + L6 * ((min(u0 + p.k, nunit) - 1) / np - sf);
    // round r-1 must stay 6 L (sf - its first slab) + STAGE steps ahead
    // of this round, or be done
    int ahead = 0, nstep_p = 0;
    if (r > 0) {
      const int sfp = (u0 - p.k) / np;
      nstep_p = T + L6 * ((u0 - 1) / np - sfp);
      ahead = L6 * (sf - sfp) + STAGE;
    }
    auto sync_rounds = [&](int done, bool wait) {
      if constexpr (MULTI) {
        if (g == 0) {
          __threadfence();
          cuda::atomic_ref<int, cuda::thread_scope_device>(prog_b[r]).store(
              done, cuda::memory_order_release);
          if (wait && r > 0) {
            cuda::atomic_ref<int, cuda::thread_scope_device> q(prog_b[r - 1]);
            const int need = min(done + ahead, nstep_p);
            while (q.load(cuda::memory_order_acquire) < need) {
            }
          }
          __threadfence();
        }
        __syncthreads();
      }
    };
    const int u = u0 + j;
    const int s = u / np, pc = u - s * np;         // slab, piece
    const int i = pc * PL + w;                     // lane in the slab
    const bool live = u < nunit && i < L;
    const int lag = L6 * (s - sf);                 // local t = tau - lag
    const int m0 = s * L + 1;
    const int m = m0 + i;
    const int a0 = live ? aa[(size_t)b * (p.Mpad + 1) + m - 1] : 0;
    const int a1 = live ? aa[(size_t)b * (p.Mpad + 1) + m] : 0;
    const int c0 = 3 * m0 + lw - 1;
    const int nb0 = c0 - 3 * i;
    const bool internal = !p.a_exgr || m < M;
    // the piece rows this lane reads (lane 0 of a later piece) or writes
    // (lane PL-1 of an earlier one)
    const bool reads_pb = live && w == 0 && pc > 0;
    const bool writes_pb = live && w == PL - 1 && pc < np - 1;
    const size_t prow = ((size_t)b * S + s) * (np - 1) + pc;
    const int* pbi = reads_pb ? pb + (prow - 1) * 5 * T : pb;
    int* pbo = writes_pb ? pb + prow * 5 * T : pb;
    for (int q = 0; q < RING; ++q) {
      rH[q * KL + g] = NEV;
      rD[q * KL + g] = 0;
      rF[q * KL + g] = NEV;
      if (DAGP) {
        rF2[q * KL + g] = NEV;
        rF2D[q * KL + g] = 0;
      }
    }
    // the E queues: slot of this step, of the next, of the one after
    int eA = NEV, eB = NEV, eC = NEV, edA = 0, edB = 0, edC = 0;
    int e2A = NEV, e2B = NEV, e2C = NEV, ed2A = 0, ed2B = 0, ed2C = 0;
    int cv[3][NCAND], cj[3][NCAND], cd[3][NCAND], c3[3][NCAND];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int l = 0; l < NCAND; ++l) {
        cv[q][l] = NEV;
        cj[q][l] = cd[q][l] = c3[q][l] = 0;
      }
    // operand windows at n-2..n+1 (code, sigE) and n-1..n+1 (sig5, accb)
    int cm2 = ld(g_code, nb0 - 2, N, 2), cm1 = ld(g_code, nb0 - 1, N, 2);
    int cz = ld(g_code, nb0, N, 2), cp1 = ld(g_code, nb0 + 1, N, 2);
    int em2 = ld(g_sigE, nb0 - 2, N, 0), em1 = ld(g_sigE, nb0 - 1, N, 0);
    int ez = ld(g_sigE, nb0, N, 0), ep1 = ld(g_sigE, nb0 + 1, N, 0);
    int s5m1 = ld(g_sig5, nb0 - 1, N, 0), s5z = ld(g_sig5, nb0, N, 0);
    int s5p1 = ld(g_sig5, nb0 + 1, N, 0);
    int abm1 = ld(g_accb, nb0 - 1, N, 0), abz = ld(g_accb, nb0, N, 0);
    int abp1 = ld(g_accb, nb0 + 1, N, 0);
    const size_t plane0 = live ? ((size_t)b * S + s) * T * NN * L + i : 0;
    unsigned char* fl_o = fl + plane0;
    int* spj_o = spj + plane0;
    signed char* php_o = php + plane0;
    __syncthreads();             // tables in; this CTA's last round done
    sync_rounds(0, true);

    for (int tau = 0; tau < nstep; ++tau) {
      const int t = tau - lag;
      if (live && t >= 0 && t < T) {
        const int n = nb0 + t;
        const int r_off = t - 6 * i;
        const bool active =
            r_off >= 0 && r_off < W && m >= 1 && n >= 0 && n <= N && m <= M;
        if (r_off == 0) {                 // lane (re)activation resets
          eA = eB = eC = NEV;
          edA = edB = edC = 0;
          e2A = e2B = e2C = NEV;
          ed2A = ed2B = ed2C = 0;
  #pragma unroll
          for (int q = 0; q < 3; ++q)
  #pragma unroll
            for (int l = 0; l < NCAND; ++l) {
              cv[q][l] = NEV;
              cj[q][l] = cd[q][l] = c3[q][l] = 0;
            }
        }
        // ---- neighbour values: lane i-1 at t-3..t-6, or the boundary
        int up_h3, up_d3, up_h4, up_d4, up_h5, up_d5, hq_v, hq_d, up_f3;
        int up_f23 = NEV, up_fd23 = 0;
        const int s1 = ((t - 1) & 7) * KL, s2 = ((t - 2) & 7) * KL;
        const int s3 = ((t - 3) & 7) * KL, s4 = ((t - 4) & 7) * KL;
        const int s5 = ((t - 5) & 7) * KL, s6 = ((t - 6) & 7) * KL;
        if (i == 0) {
          const int n0 = c0 + t;
          if (n0 >= 3 && n0 <= N) {
            up_h3 = ldg(bH + n0);
            up_d3 = ldg(bHD + n0);
            up_h4 = ldg(bH + n0 - 1);
            up_d4 = ldg(bHD + n0 - 1);
            up_h5 = ldg(bH + n0 - 2);
            up_d5 = ldg(bHD + n0 - 2);
            hq_v = ldg(bH + n0 - 3);
            hq_d = ldg(bHD + n0 - 3);
            up_f3 = ldg(bF + n0);
            if (DAGP) {
              up_f23 = ldg(bF2 + n0);
              up_fd23 = ldg(bF2D + n0);
            }
          } else {
            up_h3 = up_h4 = up_h5 = hq_v = up_f3 = NEV;
            up_d3 = up_d4 = up_d5 = hq_d = DEAD;
            up_f23 = NEV;
            up_fd23 = DEAD;
          }
        } else if (reads_pb) {            // lane PL-1 of the piece before
          auto pv = [&](int row_k, int x, int fill) {
            return x >= 0 ? __ldcg(pbi + (size_t)row_k * T + x) : fill;
          };
          up_h3 = pv(0, t - 3, NEV);
          up_d3 = pv(1, t - 3, 0);
          up_h4 = pv(0, t - 4, NEV);
          up_d4 = pv(1, t - 4, 0);
          up_h5 = pv(0, t - 5, NEV);
          up_d5 = pv(1, t - 5, 0);
          hq_v = pv(0, t - 6, NEV);
          hq_d = pv(1, t - 6, 0);
          up_f3 = pv(2, t - 3, NEV);
          if (DAGP) {
            up_f23 = pv(3, t - 3, NEV);
            up_fd23 = pv(4, t - 3, 0);
          }
        } else {
          const int v = g - 1;
          up_h3 = rH[s3 + v];
          up_d3 = rD[s3 + v];
          up_h4 = rH[s4 + v];
          up_d4 = rD[s4 + v];
          up_h5 = rH[s5 + v];
          up_d5 = rD[s5 + v];
          hq_v = rH[s6 + v];
          hq_d = rD[s6 + v];
          up_f3 = rF[s3 + v];
          if (DAGP) {
            up_f23 = rF2[s3 + v];
            up_fd23 = rF2D[s3 + v];
          }
        }
        const int left1 = rH[s1 + g], left2 = rH[s2 + g], left3 = rH[s3 + g];
        const int ld1 = rD[s1 + g], ld2 = rD[s2 + g], ld3 = rD[s3 + g];
        // band top: the vertical sources lie past up
        if (r_off >= W - 3) up_h3 = up_f3 = up_f23 = NEV;
        if (r_off >= W - 2) up_h4 = NEV;
        if (r_off >= W - 1) up_h5 = NEV;

        const int bt_n2 = cm2 & 31, bt_n1p = cp1 & 31;
        const int phs5_n = ((cz >> 13) & 7) - 2, phs3_n = ((cz >> 16) & 7) - 2;

        // ---- diagonal
        const bool h_ok = n >= 3;
        int h_val = h_ok ? hq_v + s_mtx[a0 * A_TRON + bt_n2] + em2 : NEV;
        int h_dir = h_ok ? ((hq_d == DIAG || hq_d == NEWD ||
                             hq_d == (DIAG | SPIN)) ? DIAG : NEWD)
                         : DEAD;
        int mx_val = h_val, mx_k = 0, mx_dir = h_dir;
        // ---- vertical
        int y = up_f3 + p.gep;
        int x = up_h5 + (isvert(up_d5) ? p.ge1 : p.gw1);
        bool f_open = x > y;
        int f_val = f_open ? x : y;
        int f_dir = f_open ? SLA2 : VERT;
        x = up_h4 + (isvert(up_d4) ? p.ge2 : p.gw2);
        if (x > f_val) {
          f_val = x;
          f_dir = SLA1;
          f_open = true;
        }
        x = up_h3 + p.gw3;
        if (x >= f_val) {
          f_val = x;
          f_dir = VERT;
          f_open = true;
        } else if (y >= f_val) {
          f_val = y;
          f_dir = VERT;
          f_open = false;
        }
        if (f_val > mx_val) {
          mx_val = f_val;
          mx_k = 2;
          mx_dir = f_dir;
        }
        // ---- long deletion F2 (extension keeps the source dir and SPIN)
        int f2_val = NEV, f2_dir = 0;
        bool f2_open = false;
        if (DAGP) {
          x = up_h3 + p.gw3l;
          y = up_f23 + p.lgep;
          f2_open = x >= y;
          f2_val = f2_open ? x : y;
          f2_dir = f2_open ? VERL : up_fd23;
          if (f2_val > mx_val) {
            mx_val = f2_val;
            mx_k = 4;
            mx_dir = f2_dir;
          }
        }
        // ---- horizontal (this step's queue slot)
        const int sigE2 = n >= 2 ? em2 : 0;
        int ev = eA, edir = edA;
        const bool ok3 = r_off > 2;
        x = ok3 ? left3 + p.gw3 : NEV;
        const int ev3 = ev + p.gep;
        const bool opened3 = ok3 && x > ev3;
        const int spin3 = opened3 ? (ld3 & SPIN) : (edir & SPIN);
        if (ok3) {
          ev = (opened3 ? x : ev3) + sigE2;
          edir = spin3 | HORI;
        }
        bool e_open = opened3;
        int ev2 = e2A, edir2 = ed2A;
        bool e2_open = false;
        if (DAGP) {
          const int x2 = ok3 ? left3 + p.gw3l : NEV;
          const int ev23 = ev2 + p.lgep;
          e2_open = ok3 && x2 > ev23;
          const int spin23 = e2_open ? (ld3 & SPIN) : (edir2 & SPIN);
          if (ok3) {
            ev2 = (e2_open ? x2 : ev23) + sigE2;
            edir2 = spin23 | HORL;
          }
          if (ev2 > mx_val) {
            mx_val = ev2;
            mx_k = 3;
            mx_dir = edir2;
          }
        }
        x = r_off > 1 ? left2 + p.gw2 : NEV;
        if (x > ev) {
          ev = x;
          edir = (ld2 & SPIN) | HOR2;
          e_open = true;
        }
        x = left1 + p.gw1;
        if (x > ev) {
          ev = x;
          edir = (ld1 & SPIN) | HOR1;
          e_open = true;
        }
        if (ev > mx_val) {
          mx_val = ev;
          mx_k = 1;
          mx_dir = edir;
        }

        int sv[5] = {h_val, ev, f_val, ev2, f2_val};
        int sd[5] = {h_dir, edir, f_dir, edir2, f2_dir};
        int sj[5] = {0, 0, 0, 0, 0}, sp[5] = {0, 0, 0, 0, 0};
        // ---- acceptor closes over phases -1, 0, +1
        if (internal && active && n < N && phs3_n != -2) {
  #pragma unroll
          for (int pi = 0; pi < 3; ++pi) {
            const int phs = pi - 1;
            if (!((phs3_n == 2 && phs != 0) || phs3_n == phs)) continue;
            const int nb = n - phs;
            const int acode = phs == -1 ? cp1 : (phs == 0 ? cz : cm1);
            const int accb_p = phs == -1 ? abp1 : (phs == 0 ? abz : abm1);
            const int d3_p = (acode >> 9) & 15;
            const int d5_q = ((phs == -1 ? cp1 : cm1) >> 5) & 15;
            int xc[NCAND];
            bool okc[NCAND];
  #pragma unroll
            for (int l = 0; l < NCAND; ++l) {
              const int ilen = nb - cj[pi][l];
              int v = cv[pi][l] + __ldg(ipen + clampi(ilen, 0, p.P - 1)) +
                      accb_p +
                      s_t53[clampi(16 * (c3[pi][l] & 15) + d3_p, 0, 255)];
              if (phs != 0 && cd[pi][l] == 0) {
                const int w4 = clampi(16 * ((c3[pi][l] >> 4) & 15) + d5_q, 0,
                                      255);
                if (phs == 1) {
                  v += s_mtx[a0 * A_TRON + clampi(s_t1[w4], 0, A_TRON - 1)];
                } else if (n + 1 < N) {
                  v += s_mtx[a1 * A_TRON + clampi(s_t2[w4], 0, A_TRON - 1)] -
                       s_mtx[a1 * A_TRON + clampi(bt_n1p, 0, A_TRON - 1)] -
                       ep1;
                }
              }
              okc[l] = ilen >= p.minl && cv[pi][l] > NEV / 2 &&
                       !(phs == 1 && cd[pi][l] == 2);
              xc[l] = okc[l] ? v : NEV;
            }
  #pragma unroll
            for (int k = 0; k < NN; ++k) {
              int cur = sv[k];
  #pragma unroll
              for (int l = 0; l < NCAND; ++l)
                if (cd[pi][l] == k && okc[l] && xc[l] > cur) {
                  cur = xc[l];
                  sj[k] = cj[pi][l] + 1;
                  sp[k] = phs;
                }
              sv[k] = cur;
              if (sj[k] > 0) sd[k] = sdnew[k];
              if (sj[k] > 0 && cur > mx_val) {
                mx_val = cur;
                mx_k = k;
                mx_dir = sd[k];
              }
            }
          }
        }

        // ---- winner into H; Local mode
        int h_out = mx_val, hd_out = mx_dir, mxk_tr = mx_k;
        if (p.local_r) {
          bool ok = active && mx_k == 0 && h_out > hq_v && n >= loc_hi;
          if (p.local_l) ok = ok && !(hq_d == DEAD && (hd_out & SPIN) == 0);
          if (ok && better(h_out, m, n, lv, lm, ln)) {
            lv = h_out;
            lm = m;
            ln = n;
          }
        }
        if (p.local_l && active && h_out <= 0 && n <= loc_lo) {
          h_out = 0;
          hd_out = DEAD;
          mxk_tr = 0;
          sj[0] = 0;
          if (mx_k == 0) {
            mx_val = 0;
            mx_dir = DEAD;
          }
        }

        // ---- donor pushes over phases
        if (internal && active && n < N && phs5_n != -2) {
          const int dm = mx_dir & 15;
          const int hd_nod = dm <= RSRV ? -1 : dm <= NEWD ? 0 : dm <= SLA2 ? 2
                           : dm == VERL ? 4 : dm <= HOR2 ? 1 : 3;
          const int fvs[5] = {h_out, sv[1], sv[2], sv[3], sv[4]};
          const int fds[5] = {hd_out, sd[1], sd[2], sd[3], sd[4]};
  #pragma unroll
          for (int pi = 0; pi < 3; ++pi) {
            const int phs = pi - 1;
            if (!((phs5_n == 2 && phs != 0) || phs5_n == phs)) continue;
            const int dcode = phs == -1 ? cp1 : (phs == 0 ? cz : cm1);
            const int sig5_p = phs == -1 ? s5p1 : (phs == 0 ? s5z : s5m1);
            const int code = (((dcode >> 9) & 15) << 4) | ((dcode >> 5) & 15);
  #pragma unroll
            for (int k = 0; k < NN; ++k) {
              const bool cross = phs == 1 && k == 0;
              const int fv = cross ? hq_v : fvs[k];
              const int fdir = cross ? hq_d : fds[k];
              bool elig = !(k == 0 && !cross) || hd_nod == 0;
              elig = elig && fdir != DEAD && (fdir & SPIN) == 0;
              if (!cross) {
                const int z = mx_val + ((hd_nod == 0 || ((k - hd_nod) & 1))
                                            ? gopk[k] : 0);
                if (k != hd_nod && hd_nod >= 0 && fv <= z) elig = false;
              }
              if (!elig) continue;
              const int xv = fv + sig5_p;
              const int pos = (cv[pi][0] > xv) + (cv[pi][1] > xv) +
                              (cv[pi][2] > xv) + (cv[pi][3] > xv);
  #pragma unroll
              for (int l = NCAND - 1; l >= 1; --l)
                if (l > pos) {
                  cv[pi][l] = cv[pi][l - 1];
                  cj[pi][l] = cj[pi][l - 1];
                  cd[pi][l] = cd[pi][l - 1];
                  c3[pi][l] = c3[pi][l - 1];
                }
  #pragma unroll
              for (int l = 0; l < NCAND; ++l)
                if (l == pos) {
                  cv[pi][l] = xv;
                  cj[pi][l] = n - phs;
                  cd[pi][l] = k;
                  c3[pi][l] = code;
                }
            }
          }
        }


        // ---- masked commit, emissions, planes
        const int h_c = active ? h_out : NEV;
        const int hd_c = active ? hd_out : DEAD;
        const int f_c = active ? sv[2] : NEV;
        const int f2_c = active ? sv[4] : NEV;
        const int f2d_c = active ? sd[4] : DEAD;
        if (active) {
          eA = sv[1];
          edA = sd[1];
          e2A = sv[3];
          ed2A = sd[3];
        }
        const int sw = (t & 7) * KL + g;
        rH[sw] = h_c;
        rD[sw] = hd_c;
        rF[sw] = f_c;
        if (DAGP) {
          rF2[sw] = f2_c;
          rF2D[sw] = f2d_c;
        }
        if (writes_pb) {                  // every step, as the ring
          pbo[t] = h_c;
          pbo[(size_t)T + t] = hd_c;
          pbo[(size_t)2 * T + t] = f_c;
          if (DAGP) {
            pbo[(size_t)3 * T + t] = f2_c;
            pbo[(size_t)4 * T + t] = f2d_c;
          }
        }
        if (active) {
          if (i == L - 1) {
            bH[n] = h_c;
            bHD[n] = hd_c;
            bF[n] = f_c;
            if (DAGP) {
              bF2[n] = f2_c;
              bF2D[n] = f2d_c;
            }
          }
          if (m == M) row[(size_t)b * Np2 + n] = h_c;
          if (n == N) rc[(size_t)b * (p.Mpad + 2) + m] = h_c;
        }
        const size_t cell = (size_t)t * NN * L;
        fl_o[cell] = active ? (unsigned char)(clampi(hd_out, 0, 31) |
                                              (mxk_tr << 5))
                            : (unsigned char)255;
        fl_o[cell + L] = (unsigned char)((sd[1] & 31) | (e_open ? 0x80 : 0));
        fl_o[cell + 2 * L] =
            (unsigned char)((sd[2] & 31) | (f_open ? 0x80 : 0));
        if (DAGP) {
          fl_o[cell + 3 * L] =
              (unsigned char)((sd[3] & 31) | (e2_open ? 0x80 : 0));
          fl_o[cell + 4 * L] =
              (unsigned char)((sd[4] & 31) | (f2_open ? 0x80 : 0));
        }
  #pragma unroll
        for (int k = 0; k < NN; ++k) {
          spj_o[cell + k * L] = sj[k];
          php_o[cell + k * L] = (signed char)sp[k];
        }
        // the queue slot of step t serves again at t + 3
        int tq = eA;
        eA = eB; eB = eC; eC = tq;
        tq = edA;
        edA = edB; edB = edC; edC = tq;
        tq = e2A;
        e2A = e2B; e2B = e2C; e2C = tq;
        tq = ed2A;
        ed2A = ed2B; ed2B = ed2C; ed2C = tq;
        // slide the operand windows to n + 1
        cm2 = cm1; cm1 = cz; cz = cp1; cp1 = ld(g_code, n + 2, N, 2);
        em2 = em1; em1 = ez; ez = ep1; ep1 = ld(g_sigE, n + 2, N, 0);
        s5m1 = s5z; s5z = s5p1; s5p1 = ld(g_sig5, n + 2, N, 0);
        abm1 = abz; abz = abp1; abp1 = ld(g_accb, n + 2, N, 0);
      }
      __syncthreads();
      if ((tau + 1) % STAGE == 0) sync_rounds(tau + 1, true);
    }
    sync_rounds(nstep, false);
  }
  // best LocalR end over the lanes, in (value desc, m asc, n asc) order:
  // each CTA's, then (MULTI) CTA 0's over the cluster's
  if (p.local_r) {
    __syncthreads();
    rH[g] = lv;
    rD[g] = lm;
    rF[g] = ln;
    __syncthreads();
    int bv = NEV, bm = 0, bn = 0;
    if (g == 0)
      for (int x = 0; x < KL; ++x)
        if (rH[x] > NEV && better(rH[x], rD[x], rF[x], bv, bm, bn)) {
          bv = rH[x];
          bm = rD[x];
          bn = rF[x];
        }
    if constexpr (MULTI) {
      int* lb = lbest + (size_t)b * ncta * 3;
      if (g == 0) {
        lb[cq * 3] = bv;
        lb[cq * 3 + 1] = bm;
        lb[cq * 3 + 2] = bn;
      }
      cooperative_groups::this_cluster().sync();
      if (g == 0 && cq == 0)
        for (int q = 1; q < ncta; ++q) {
          const int v = __ldcg(lb + q * 3), vm = __ldcg(lb + q * 3 + 1),
                    vn = __ldcg(lb + q * 3 + 2);
          if (v > NEV && better(v, vm, vn, bv, bm, bn)) {
            bv = v;
            bm = vm;
            bn = vn;
          }
        }
    }
    if (g == 0 && cq == 0) {
      loc[b * 3] = bv;
      loc[b * 3 + 1] = bm;
      loc[b * 3 + 2] = bn;
    }
  } else if (g == 0 && cq == 0) {
    loc[b * 3] = NEV;
    loc[b * 3 + 1] = 0;
    loc[b * 3 + 2] = 0;
  }
}

// K8 (_tron_tb_walker's step, records of moves only, in walk order).
//
// What bounds it on the H100: latency.  A walk is a chain of steps, each
// reading the junction word, phase and flags of the cell the last step
// reached (a diagonal step goes to (i - 1, t - 6), an E move to (i, t -
// 1..3), an F move to (i - 1, t - 3..5); intron closes and split codons
// jump): one global round trip a step, from HBM once the planes outgrow
// the L2.
//
// Design: one warp a problem (a CTA each).  The warp stages in shared
// memory, in one round trip, the cells a run of diagonal steps reaches:
// lane k reads the three planes of every state at (i - k, t - 6k), k <
// 32, from the step's cell (i, t), within its slab's lanes and the
// planes' rows (a band of the diagonal, no wider: the planes keep a
// row's states apart, so a staged rectangle costs a 128-byte line per
// row, state and plane, six rows a diagonal step, and one SM's misses
// queue behind each other).  A step whose cell is off the staged
// diagonal (an E or F move, an intron close, a split codon's jump, a
// slab crossing, the band's end) stages the band from that cell.  Every
// lane runs the same walk on
// the same values (broadcast reads, no divergence).  A run of plain
// diagonal steps in state 0 takes a loop of its own whose chain is two
// shared-memory reads and one test.  The walk's slab and lane follow m
// by a decrement, not a division.  Lane cnt % 32 keeps record cnt, and
// the warp writes each run of 32 records at once.  tron_walk_tiles in
// dp_tron_cuda.py models the loads.
constexpr int TW_CELLS = 32;                     // cells of a staged band
constexpr int TW_STEP_T = 6;                     // rows a diagonal step

__global__ void __launch_bounds__(32)
tron_walk_kernel(const unsigned char* __restrict__ fl,
                 const int* __restrict__ spj,
                 const signed char* __restrict__ php,
                 const int* __restrict__ meta, const int* __restrict__ ends,
                 int* __restrict__ recs, int* __restrict__ counts,
                 int* __restrict__ done_out, int B, int S, int T, int L,
                 int NN, int IT, int NM, int NR, int* __restrict__ stats) {
  // the band: flags, junction words and phases of every state
  __shared__ int bf[5][TW_CELLS], bj[5][TW_CELLS], bp[5][TW_CELLS];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int lw = meta[b * NM + 2];
  const size_t NL = (size_t)NN * L;
  int m = ends[b * 2], n = ends[b * 2 + 1], st = 0, cnt = 0;
  bool done = m < 1 || n < 1;
  // the walk's slab and lane of row m (m >= 1 while it runs), and the
  // offset of its cell's step t: t = n + tc + 3 i
  int s = done ? 0 : (m - 1) / L, i = done ? 0 : (m - 1) % L;
  int tc = -3 * (s * L + 1) - lw + 1;
  // the band in force: slab bs, cells (bi - k, bt - 6k) for k < blen
  int bs = -1, bi = 0, bt = 0, blen = 0, loads = 0;
  int h0 = 0, h1 = 0, h2 = 0, h3 = 0, h4 = 0;         // the record kept
  int* out = recs + (size_t)b * IT * NR;
  // record cnt: lane cnt % 32 keeps it, the warp stores 32 at once
  auto emit = [&](int kind, int a1, int a2) {
    if (lane == (cnt & 31)) {
      h0 = kind; h1 = m; h2 = n; h3 = a1; h4 = a2;
    }
    if ((++cnt & 31) == 0) {
      int* o = out + (size_t)(cnt - 32 + lane) * NR;
      o[0] = h0; o[1] = h1; o[2] = h2; o[3] = h3; o[4] = h4;
    }
  };
  int it = 0;
  while (it < IT && !done) {
    const int t = n + tc + 3 * i;
    if (t < 0 || t >= T || s >= S) {
      done = true;
      break;
    }
    int k = bi - i;
    if (s != bs || (unsigned)k >= (unsigned)blen
        || t != bt - TW_STEP_T * k) {
      bs = s;
      bi = i;
      bt = t;
      blen = min(min(TW_CELLS, i + 1), t / TW_STEP_T + 1);
      k = 0;
      __syncwarp();                         // every lane is off the old band
      if (lane < blen) {
        const size_t c = (((size_t)b * S + s) * T + t - TW_STEP_T * lane)
                             * NL + (i - lane);
        int f[5], j[5], p[5];
#pragma unroll
        for (int q = 0; q < 5; ++q)
          if (q < NN) {
            f[q] = fl[c + q * L];
            j[q] = spj[c + q * L];
            p[q] = php[c + q * L];
          }
#pragma unroll
        for (int q = 0; q < 5; ++q)
          if (q < NN) {
            bf[q][lane] = f[q];
            bj[q][lane] = j[q];
            bp[q][lane] = p[q];
          }
      }
      __syncwarp();                         // the band is staged
      ++loads;
    }
    if (st == 0) {
      // a run of plain diagonal steps (state 0, no winner, not dead, no
      // intron close) along the band
      for (;;) {
        const int f = bf[0][k];
        if (((f & 0xE0) | bj[0][k]) != 0 || (f & 15) == DEAD) break;
        emit(1, 0, 0);
        ++it;
        --m;
        n -= 3;
        ++k;
        if (--i < 0) {                      // the slab above: a new band
          i = L - 1;
          --s;
          tc += 3 * L;
        }
        done = m < 1 || n < 1;
        if (done || it >= IT || k >= blen || s != bs) break;
      }
      if (done || it >= IT || k >= blen || s != bs) continue;
    }
    const int stc = st < NN ? st : NN - 1;
    const int jnc = bj[stc][k];
    const int phs = bp[stc][k];
    int kind = 0, a1 = 0, a2 = 0, n2 = n, st2 = st;
    bool dead = false, up = false;          // up: to row m - 1
    if (st == 0) {
      const int flh = bf[0][k];
      const int winner = (flh >> 5) & 7;
      if (flh == 255 || (winner == 0 && jnc == 0 && (flh & 15) == DEAD)) {
        dead = true;
      } else if (winner != 0) {
        st2 = winner;
      } else if (jnc > 0) {
        kind = phs == 1 ? 5 : 4;
        a1 = jnc - 1;
        a2 = phs;
        if (phs == 1) {
          up = true;
          n2 = jnc - 3;
        } else {
          n2 = phs == 0 ? jnc - 1 : jnc - 2;
        }
      } else {
        kind = 1;
        up = true;
        n2 = n - 3;
      }
    } else if (jnc > 0) {                   // a gap state's intron close
      kind = 4;
      a1 = jnc - 1;
      a2 = phs;
      n2 = jnc - 1 + phs;
    } else {
      const int fg = bf[st][k];
      const int base = fg & 15;
      if (st == 1 || st == 3) {
        kind = 2;
        a1 = base == HOR2 ? 2 : (base == HOR1 ? 1 : 3);
        n2 = n - a1;
      } else {
        kind = 3;
        a1 = base == SLA2 ? 2 : (base == SLA1 ? 1 : 0);
        up = true;
        n2 = n - a1;
      }
      if (fg & 0x80) st2 = 0;
    }
    if (kind) emit(kind, a1, a2);
    if (up) {                               // row m - 1: the lane above
      --m;
      if (--i < 0) {
        i = L - 1;
        --s;
        tc += 3 * L;
      }
    }
    done = dead || m < 1 || n2 < 1;
    n = n2;
    st = st2;
    ++it;
  }
  const int pend = cnt & 31;                // records not yet written
  if (lane < pend) {
    int* o = out + (size_t)(cnt - pend + lane) * NR;
    o[0] = h0; o[1] = h1; o[2] = h2; o[3] = h3; o[4] = h4;
  }
  if (lane == 0) {
    counts[b] = cnt;
    done_out[b] = done ? 1 : 0;
    if (stats) {
      stats[b * 2] = it;
      stats[b * 2 + 1] = loads;
    }
  }
}


// One launch of K7: B * ncta CTAs (clusters of ncta) of `threads`
// threads, smem bytes of dynamic shared memory, as tron_geometry chose
// them: k units of L lanes (threads = k L <= max_threads), or one piece
// of PL = ceil(L / np) lanes of a slab wider than max_threads (np =
// ceil(L / max_threads), k = 1).  A launch the instance cannot take is
// refused with cudaErrorInvalidValue; nothing runs with other numbers.
template <bool DAGP>
int launch_forward(const int* gen, const int* aa, const int* meta,
                   const int* tabs, int* bnd, int* pb, int* prog,
                   int* lbest, unsigned char* fl, int* spj,
                   signed char* php, int* row, int* rc, int* loc,
                   TronArgs a, int threads, int smem, cudaStream_t stream) {
  constexpr int MAXT = max_threads(DAGP);
  a.np = (a.L + MAXT - 1) / MAXT;
  a.PL = (a.L + a.np - 1) / a.np;
  if (a.k < 1 || a.ncta < 1 || a.ncta > CLUSTER_MAX || threads > MAXT
      || threads != a.k * a.PL || (a.np > 1 && a.k != 1)
      || smem < 4 * tron_smem_ints(threads, DAGP))
    return (int)cudaErrorInvalidValue;
  auto kern = a.ncta > 1 ? tron_forward_kernel<DAGP, true>
                         : tron_forward_kernel<DAGP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.B * a.ncta);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (a.ncta > 1) {                 // the CTAs of a problem, together
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kern, gen, aa, meta, tabs, bnd, pb, prog,
                         lbest, fl, spj, php, row, rc, loc, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool DAGP>
int forward_entry(const int* gen, const int* aa, const int* meta,
                  const int* tabs, int* bnd, unsigned char* fl, int* spj,
                  signed char* php, int* row, int* rc, int* loc, int B,
                  int L, int S, int T, int W, int Nmax, int Mpad, int P,
                  int local_l, int local_r, int a_exgr, int gop, int gep,
                  int ge1, int ge2, int gw1, int gw2, int gw3, int minl,
                  int lgop, int lgep, int gw3l, int k, int threads,
                  int ncta, int smem, int* prog, int* pb, int* lbest,
                  cudaStream_t stream) {
  if (B <= 0) return 0;
  if (L < 3 || L > 1024) return (int)cudaErrorInvalidValue;
  const TronArgs a{B, L, S, T, W, Nmax, Mpad, P, local_l, local_r, a_exgr,
                   gop, gep, ge1, ge2, gw1, gw2, gw3, minl, lgop, lgep,
                   gw3l, k, ncta, 1, L};
  return launch_forward<DAGP>(gen, aa, meta, tabs, bnd, pb, prog, lbest,
                              fl, spj, php, row, rc, loc, a, threads, smem,
                              stream);
}

}  // namespace

extern "C" {

const char* tron_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The forward entries take the operands and outputs, the shapes, the
// modes and scores, then the geometry of tron_geometry (k units a CTA,
// threads, ncta CTAs a problem, smem bytes) and the wrapper's scratch:
// prog (B * rounds ints, zeroed), pb (the piece rows, np > 1) and lbest
// (B * ncta * 3 ints).
#define FORWARD_PARAMS                                                    \
  const int *gen, const int *aa, const int *meta, const int *tabs,         \
      int *bnd, unsigned char *fl, int *spj, signed char *php, int *row,   \
      int *rc, int *loc, int B, int L, int S, int T, int W, int Nmax,      \
      int Mpad, int P, int local_l, int local_r, int a_exgr, int gop,      \
      int gep, int ge1, int ge2, int gw1, int gw2, int gw3, int minl,      \
      int lgop, int lgep, int gw3l, int k, int threads, int ncta,          \
      int smem, int *prog, int *pb, int *lbest, cudaStream_t stream
#define FORWARD_ARGS                                                      \
  gen, aa, meta, tabs, bnd, fl, spj, php, row, rc, loc, B, L, S, T, W,     \
      Nmax, Mpad, P, local_l, local_r, a_exgr, gop, gep, ge1, ge2, gw1,    \
      gw2, gw3, minl, lgop, lgep, gw3l, k, threads, ncta, smem, prog, pb,  \
      lbest, stream

int tron_forward(FORWARD_PARAMS) { return forward_entry<false>(FORWARD_ARGS); }

int tron_forward_dagp(FORWARD_PARAMS) {
  return forward_entry<true>(FORWARD_ARGS);
}

int tron_walk(const unsigned char* fl, const int* spj,
              const signed char* php, const int* meta, const int* ends,
              int* recs, int* counts, int* done, int B, int S, int T, int L,
              int NN, int IT, int NM, int NR, int* stats,
              cudaStream_t stream) {
  if (B <= 0) return 0;
  if (NN != 3 && NN != 5) return (int)cudaErrorInvalidValue;
  tron_walk_kernel<<<B, 32, 0, stream>>>(fl, spj, php, meta, ends, recs,
                                         counts, done, B, S, T, L, NN, IT,
                                         NM, NR, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
