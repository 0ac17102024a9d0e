// Native runtime components (C ABI, loaded via ctypes).
//
// The reference's hot host-side loops are C++ (index build
// blksrc.cc:403-531 Chash::countBlk/registBlk over genome k-mers with a
// thread pipeline, blksrc.cc:1419-1692; FASTA reading seq.cc).  The TPU
// port keeps the device DP in XLA/Pallas but gives the host runtime the
// same native treatment: a parallel two-pass k-mer -> block CSR builder
// and a FASTA byte-stream encoder.
//
// Build: make -C spaln_tpu/native   (g++ -O3 -shared -fPIC, std::thread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------- fasta encode
// Encode FASTA text into nt codes (seq.cc:56 alphabet) in one pass.
// Returns number of sequences found; fills codes (caller-sized >= text
// length), per-seq offsets into codes, and name spans into the text.
int64_t fasta_encode(const char* text, int64_t n, int8_t* codes,
                     int64_t* seq_off, int64_t* name_beg,
                     int64_t* name_end, int64_t max_seqs,
                     const int8_t* enc_tab, int64_t* out_len) {
    int64_t nseq = 0, w = 0;
    int64_t i = 0;
    while (i < n) {
        if (text[i] == '>') {
            if (nseq >= max_seqs) break;
            int64_t b = ++i;
            while (i < n && text[i] != '\n' && text[i] != ' '
                   && text[i] != '\t') ++i;
            name_beg[nseq] = b;
            name_end[nseq] = i;
            while (i < n && text[i] != '\n') ++i;
            seq_off[nseq++] = w;
        } else {
            unsigned char c = (unsigned char)text[i];
            if (c > ' ') codes[w++] = enc_tab[c];
            ++i;
        }
        if (i < n && text[i] == '\n') ++i;
    }
    *out_len = w;
    return nseq;
}

// ------------------------------------------------- k-mer -> block CSR
// Two-pass count/fill (Chash::countBlk/registBlk role) parallelized over
// genome slices; dedups (word, block) pairs by remembering the last
// block registered per word within a pass (valid because positions are
// scanned in order within each slice and blocks are position-monotone).
struct CsrScratch {
    std::vector<std::atomic<int64_t>> counts;
};

// pass 1: per-word unique-block counts.  red: reduced codes (0..3, >=4 =
// ambiguous).  Returns total pairs.
int64_t kmer_csr(const int8_t* red, int64_t n, int32_t k, int32_t blklen,
                 int64_t* offsets /* 4^k + 1, zeroed */,
                 int32_t* blocks /* out, sized by caller after pass 1 */,
                 int32_t two_pass_fill, int32_t nthreads) {
    const int64_t nwords = (int64_t)1 << (2 * k);
    const int64_t mask = nwords - 1;
    if (n < k) return 0;
    const int64_t npos = n - k + 1;

    // scan phase: each thread slices the genome and radix-buckets its
    // (word, block) pairs by high word bits, so the merge phase can run
    // one thread per word range with no synchronization (the reference
    // harvests slices serially, blksrc.cc:1485; here both phases scale)
    if (nthreads < 1) nthreads = 1;
    int nb = 1;
    while (nb < 4 * nthreads && nb < 256 && (int64_t)nb < nwords) nb <<= 1;
    const int bshift = 2 * k - __builtin_ctz(nb);
    std::vector<std::vector<std::vector<std::pair<int64_t,int32_t>>>>
        parts(nthreads);
    std::vector<std::thread> ths;
    int64_t chunk = (npos + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        ths.emplace_back([&, t]() {
            int64_t lo = t * chunk;
            int64_t hi = lo + chunk < npos ? lo + chunk : npos;
            if (lo >= hi) return;
            auto& out = parts[t];
            out.resize(nb);
            for (auto& v : out) v.reserve((hi - lo) / (2 * nb) + 8);
            int64_t w = 0;
            int bad = k;            // bases until word valid again
            // warm up k-1 bases before lo
            for (int64_t p = lo; p < hi + k - 1 && p < n; ++p) {
                int8_t c = red[p];
                w = ((w << 2) | (c & 3)) & mask;
                bad = (c >= 4) ? k : (bad > 0 ? bad - 1 : 0);
                int64_t pos = p - k + 1;
                if (pos < lo || pos >= hi) continue;
                if (bad > 0) continue;
                out[w >> bshift].emplace_back(w, (int32_t)(pos / blklen));
            }
        });
    }
    for (auto& th : ths) th.join();

    // merge phase: one thread per word-range bucket; per-word last-block
    // dedup stays valid because every word lives in exactly one bucket
    // and parts are visited in genome order
    std::vector<int64_t> totals(nb, 0);
    std::vector<std::thread> mths;
    std::vector<int64_t> cursor;
    if (two_pass_fill) {
        cursor.resize(nwords);
        for (int64_t i2 = 0; i2 < nwords; ++i2) cursor[i2] = offsets[i2];
    }
    for (int b0 = 0; b0 < nb; ++b0) {
        mths.emplace_back([&, b0]() {
            const int64_t wlo = (int64_t)b0 << bshift;
            const int64_t whi = (int64_t)(b0 + 1) << bshift;
            std::vector<int32_t> last(whi - wlo, -1);
            int64_t tot = 0;
            for (int t = 0; t < nthreads; ++t) {
                if ((int)parts[t].size() <= b0) continue;
                for (auto& pb : parts[t][b0]) {
                    if (last[pb.first - wlo] == pb.second) continue;
                    last[pb.first - wlo] = pb.second;
                    if (two_pass_fill)
                        blocks[cursor[pb.first]++] = pb.second;
                    else
                        offsets[pb.first + 1]++;
                    ++tot;
                }
            }
            totals[b0] = tot;
        });
        if ((int)mths.size() >= nthreads) {
            for (auto& th : mths) th.join();
            mths.clear();
        }
    }
    for (auto& th : mths) th.join();
    int64_t total = 0;
    for (int b0 = 0; b0 < nb; ++b0) total += totals[b0];
    if (!two_pass_fill)
        for (int64_t i2 = 0; i2 < nwords; ++i2)
            offsets[i2 + 1] += offsets[i2];
    return total;
}

}  // extern "C"
