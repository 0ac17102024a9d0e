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
// (spaln_tpu/ops/dp_tron_scan.py:116-629, 820-946), a lax.scan over
// (B, L) vectors; K8 replaces _tron_tb_walker (1113-1206).  All
// arithmetic is int32 x10 fixed point in the scan step's operation
// order, which fixes every tie-break, so results equal the reference's
// exactly.
//
// K7: one CTA a problem, one thread a lane (aa row m = m0 + i of slab
// s, m0 = s L + 1), the problem's slabs in order.  At step t lane i
// computes n = 3 m0 + lw - 1 + t - 3i; it reads lane i-1 at t-3..t-6
// (vertical, 2/1-nt slides, codon diagonal) and itself at t-1..t-3 (the
// E queue) from an 8-step ring in shared memory, one barrier a step;
// lane 0 reads the previous slab's last row from the boundary rows in
// global memory, which lane L-1 rewrites 3(L-1) nt behind (so L >= 3).
// Per lane the state is in registers: the three 3-frame E queues, the
// three per-phase donor lists of 4 candidates (value, donor position,
// state, dinucleotide pair: 48 ints) and sliding windows of the genome
// operands at n-2..n+1.  The bound is the step's latency: a serial
// chain of some 400 integer selects between two barriers, with B CTAs
// of L threads in flight; the planes (6 bytes a state a cell) are the
// only traffic of size.  Making it fast (several slabs in flight, the
// rings in registers) is later work.
//
// K8: one thread a problem walks its planes from its end cell back to
// the matrix edge: 5 states, per-phase junction closes, split codons.
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
//   fl    (B, S, T, NN, L) u8     H: dir | winner << 5 (255 inactive);
//                                 E, F, E2, F2: dir | 0x80 if opened
//   spj   (B, S, T, NN, L) int32  1 + donor position of an intron closed
//                                 into state k; php the same, int8 phase
//   row   (B, Nmax + 2)           H(M, n); rc (B, Mpad + 2) H(m, N)
//   loc   (B, 3)                  best LocalR end (value, m, n)
//   recs  (B, IT, 5)              K8 records (kind, m, n, a1, a2)
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
constexpr int NARROW = 256;             // lanes of the 255-register instance

struct TronArgs {
  int B, L, S, T, W, Nmax, Mpad, P, local_l, local_r, a_exgr;
  int gop, gep, ge1, ge2, gw1, gw2, gw3, minl, lgop, lgep, gw3l;
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

template <bool DAGP, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : NARROW)
    tron_forward_kernel(const int* __restrict__ gen,
                        const int* __restrict__ aa,
                        const int* __restrict__ meta,
                        const int* __restrict__ tabs, int* bnd,
                        unsigned char* __restrict__ fl,
                        int* __restrict__ spj, signed char* __restrict__ php,
                        int* __restrict__ row, int* __restrict__ rc,
                        int* __restrict__ loc, TronArgs p) {
  constexpr int NN = DAGP ? 5 : 3;
  extern __shared__ int sm[];
  const int L = p.L;
  int* s_tab = sm;                                   // T_IPEN ints
  int* rH = sm + T_IPEN;
  int* rD = rH + RING * L;
  int* rF = rD + RING * L;
  int* rF2 = rF + RING * L;
  int* rF2D = rF2 + RING * L;
  const int* s_mtx = s_tab;
  const int* s_t53 = s_tab + T_T53;
  const int* s_t1 = s_tab + T_T1;
  const int* s_t2 = s_tab + T_T2;
  const int* ipen = tabs + T_IPEN;
  const int b = blockIdx.x, i = threadIdx.x;
  for (int j = i; j < T_IPEN; j += L) s_tab[j] = tabs[j];
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
  const int gopk[5] = {0, 0, p.gop, p.gop, p.lgop};
  const int sdnew[5] = {DIAG | SPIN, HORI | SPIN, VERT | SPIN, HORL | SPIN,
                        VERL | SPIN};
  int lv = NEV, lm = 0, ln = 0;                     // best LocalR end

  for (int s = 0; s < S; ++s) {
    const int m0 = s * L + 1;
    const int m = m0 + i;
    const int a0 = aa[(size_t)b * (p.Mpad + 1) + m - 1];
    const int a1 = aa[(size_t)b * (p.Mpad + 1) + m];
    const int c0 = 3 * m0 + lw - 1;
    const int nb0 = c0 - 3 * i;
    const bool internal = !p.a_exgr || m < M;
    for (int k = 0; k < RING; ++k) {
      rH[k * L + i] = NEV;
      rD[k * L + i] = 0;
      rF[k * L + i] = NEV;
      if (DAGP) {
        rF2[k * L + i] = NEV;
        rF2D[k * L + i] = 0;
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
    __syncthreads();

    for (int t = 0; t < T; ++t) {
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
      const int s1 = ((t - 1) & 7) * L, s2 = ((t - 2) & 7) * L;
      const int s3 = ((t - 3) & 7) * L, s4 = ((t - 4) & 7) * L;
      const int s5 = ((t - 5) & 7) * L, s6 = ((t - 6) & 7) * L;
      if (i == 0) {
        const int n0 = c0 + t;
        if (n0 >= 3 && n0 <= N) {
          up_h3 = bH[n0];
          up_d3 = bHD[n0];
          up_h4 = bH[n0 - 1];
          up_d4 = bHD[n0 - 1];
          up_h5 = bH[n0 - 2];
          up_d5 = bHD[n0 - 2];
          hq_v = bH[n0 - 3];
          hq_d = bHD[n0 - 3];
          up_f3 = bF[n0];
          if (DAGP) {
            up_f23 = bF2[n0];
            up_fd23 = bF2D[n0];
          }
        } else {
          up_h3 = up_h4 = up_h5 = hq_v = up_f3 = NEV;
          up_d3 = up_d4 = up_d5 = hq_d = DEAD;
          up_f23 = NEV;
          up_fd23 = DEAD;
        }
      } else {
        const int j = i - 1;
        up_h3 = rH[s3 + j];
        up_d3 = rD[s3 + j];
        up_h4 = rH[s4 + j];
        up_d4 = rD[s4 + j];
        up_h5 = rH[s5 + j];
        up_d5 = rD[s5 + j];
        hq_v = rH[s6 + j];
        hq_d = rD[s6 + j];
        up_f3 = rF[s3 + j];
        if (DAGP) {
          up_f23 = rF2[s3 + j];
          up_fd23 = rF2D[s3 + j];
        }
      }
      const int left1 = rH[s1 + i], left2 = rH[s2 + i], left3 = rH[s3 + i];
      const int ld1 = rD[s1 + i], ld2 = rD[s2 + i], ld3 = rD[s3 + i];
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
      const int sw = (t & 7) * L + i;
      rH[sw] = h_c;
      rD[sw] = hd_c;
      rF[sw] = f_c;
      if (DAGP) {
        rF2[sw] = f2_c;
        rF2D[sw] = f2d_c;
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
      const size_t cell = (((size_t)b * S + s) * T + t) * NN * L + i;
      fl[cell] = active ? (unsigned char)(clampi(hd_out, 0, 31) |
                                          (mxk_tr << 5))
                        : (unsigned char)255;
      fl[cell + L] = (unsigned char)((sd[1] & 31) | (e_open ? 0x80 : 0));
      fl[cell + 2 * L] = (unsigned char)((sd[2] & 31) | (f_open ? 0x80 : 0));
      if (DAGP) {
        fl[cell + 3 * L] =
            (unsigned char)((sd[3] & 31) | (e2_open ? 0x80 : 0));
        fl[cell + 4 * L] =
            (unsigned char)((sd[4] & 31) | (f2_open ? 0x80 : 0));
      }
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        spj[cell + k * L] = sj[k];
        php[cell + k * L] = (signed char)sp[k];
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
      __syncthreads();
    }
  }
  // best LocalR end over the lanes, in (value desc, m asc, n asc) order
  if (p.local_r) {
    rH[i] = lv;
    rD[i] = lm;
    rF[i] = ln;
    __syncthreads();
    if (i == 0) {
      int bv = NEV, bm = 0, bn = 0;
      for (int j = 0; j < L; ++j)
        if (rH[j] > NEV && better(rH[j], rD[j], rF[j], bv, bm, bn)) {
          bv = rH[j];
          bm = rD[j];
          bn = rF[j];
        }
      loc[b * 3] = bv;
      loc[b * 3 + 1] = bm;
      loc[b * 3 + 2] = bn;
    }
  } else if (i == 0) {
    loc[b * 3] = NEV;
    loc[b * 3 + 1] = 0;
    loc[b * 3 + 2] = 0;
  }
}

// K8: one thread a problem (_tron_tb_walker's step, records of moves
// only, in walk order)
__global__ void tron_walk_kernel(const unsigned char* __restrict__ fl,
                                 const int* __restrict__ spj,
                                 const signed char* __restrict__ php,
                                 const int* __restrict__ meta,
                                 const int* __restrict__ ends,
                                 int* __restrict__ recs,
                                 int* __restrict__ counts,
                                 int* __restrict__ done_out, int B, int S,
                                 int T, int L, int NN, int IT, int NM,
                                 int NR) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int lw = meta[b * NM + 2];
  int m = ends[b * 2], n = ends[b * 2 + 1], st = 0, cnt = 0;
  bool done = m < 1 || n < 1;
  int* out = recs + (size_t)b * IT * NR;
  for (int it = 0; it < IT && !done; ++it) {
    const int s = (m - 1) / L;              // m >= 1 while not done
    const int i = (m - 1) - s * L;
    const int t = n - 3 * (s * L + 1) - lw + 1 + 3 * i;
    if (t < 0 || t >= T || s >= S) {
      done = true;
      break;
    }
    const size_t cell = (((size_t)b * S + s) * T + t) * NN * L + i;
    const int stc = st < NN ? st : NN - 1;
    const int jnc = spj[cell + stc * L];
    const int phs = php[cell + stc * L];
    int kind = 0, a1 = 0, a2 = 0, m2 = m, n2 = n, st2 = st;
    bool dead = false;
    if (st == 0) {
      const int flh = fl[cell];
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
          m2 = m - 1;
          n2 = jnc - 3;
        } else {
          n2 = phs == 0 ? jnc - 1 : jnc - 2;
        }
      } else {
        kind = 1;
        m2 = m - 1;
        n2 = n - 3;
      }
    } else if (jnc > 0) {                   // a gap state's intron close
      kind = 4;
      a1 = jnc - 1;
      a2 = phs;
      n2 = jnc - 1 + phs;
    } else {
      const int fg = fl[cell + st * L];
      const int base = fg & 15;
      if (st == 1 || st == 3) {
        kind = 2;
        a1 = base == HOR2 ? 2 : (base == HOR1 ? 1 : 3);
        n2 = n - a1;
      } else {
        kind = 3;
        a1 = base == SLA2 ? 2 : (base == SLA1 ? 1 : 0);
        m2 = m - 1;
        n2 = n - a1;
      }
      if (fg & 0x80) st2 = 0;
    }
    if (kind) {
      int* r = out + (size_t)cnt * NR;
      r[0] = kind;
      r[1] = m;
      r[2] = n;
      r[3] = a1;
      r[4] = a2;
      ++cnt;
    }
    done = dead || m2 < 1 || n2 < 1;
    m = m2;
    n = n2;
    st = st2;
  }
  counts[b] = cnt;
  done_out[b] = done ? 1 : 0;
}

template <bool DAGP, bool WIDE>
int launch_forward(const int* gen, const int* aa, const int* meta,
                   const int* tabs, int* bnd, unsigned char* fl, int* spj,
                   signed char* php, int* row, int* rc, int* loc,
                   const TronArgs& a, cudaStream_t stream) {
  const int rings = DAGP ? 5 : 3;     // H, dir, F (F2, its dir)
  const size_t smem = sizeof(int) * ((size_t)T_IPEN + rings * RING * a.L);
  auto kern = tron_forward_kernel<DAGP, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B, a.L, smem, stream>>>(gen, aa, meta, tabs, bnd, fl, spj, php,
                                   row, rc, loc, a);
  return (int)cudaGetLastError();
}

template <bool DAGP>
int forward_entry(const int* gen, const int* aa, const int* meta,
                  const int* tabs, int* bnd, unsigned char* fl, int* spj,
                  signed char* php, int* row, int* rc, int* loc, int B,
                  int L, int S, int T, int W, int Nmax, int Mpad, int P,
                  int local_l, int local_r, int a_exgr, int gop, int gep,
                  int ge1, int ge2, int gw1, int gw2, int gw3, int minl,
                  int lgop, int lgep, int gw3l, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (L < 3 || L > 1024) return (int)cudaErrorInvalidValue;
  const TronArgs a{B, L, S, T, W, Nmax, Mpad, P, local_l, local_r, a_exgr,
                   gop, gep, ge1, ge2, gw1, gw2, gw3, minl, lgop, lgep,
                   gw3l};
  if (L <= NARROW)
    return launch_forward<DAGP, false>(gen, aa, meta, tabs, bnd, fl, spj,
                                       php, row, rc, loc, a, stream);
  return launch_forward<DAGP, true>(gen, aa, meta, tabs, bnd, fl, spj, php,
                                    row, rc, loc, a, stream);
}

}  // namespace

extern "C" {

const char* tron_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define FORWARD_PARAMS                                                    \
  const int *gen, const int *aa, const int *meta, const int *tabs,         \
      int *bnd, unsigned char *fl, int *spj, signed char *php, int *row,   \
      int *rc, int *loc, int B, int L, int S, int T, int W, int Nmax,      \
      int Mpad, int P, int local_l, int local_r, int a_exgr, int gop,      \
      int gep, int ge1, int ge2, int gw1, int gw2, int gw3, int minl,      \
      int lgop, int lgep, int gw3l, cudaStream_t stream
#define FORWARD_ARGS                                                      \
  gen, aa, meta, tabs, bnd, fl, spj, php, row, rc, loc, B, L, S, T, W,     \
      Nmax, Mpad, P, local_l, local_r, a_exgr, gop, gep, ge1, ge2, gw1,    \
      gw2, gw3, minl, lgop, lgep, gw3l, stream

int tron_forward(FORWARD_PARAMS) { return forward_entry<false>(FORWARD_ARGS); }

int tron_forward_dagp(FORWARD_PARAMS) {
  return forward_entry<true>(FORWARD_ARGS);
}

int tron_walk(const unsigned char* fl, const int* spj,
              const signed char* php, const int* meta, const int* ends,
              int* recs, int* counts, int* done, int B, int S, int T, int L,
              int NN, int IT, int NM, int NR, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 64;
  tron_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      fl, spj, php, meta, ends, recs, counts, done, B, S, T, L, NN, IT, NM,
      NR);
  return (int)cudaGetLastError();
}

}  // extern "C"
