// apd_native: C++ host-side numeric runtime.
//
// The reference implements its host numerics in a Rust cdylib
// (reference: native-helper/src/lib.rs); this is the framework's
// equivalent for the ops that belong on the host: the inherently
// sequential BS.1770 K-weighting IIR for init-time clip preparation, the
// branchy scipy-compatible peak machinery used by the exactness fallback,
// Pearson/Simpson, window-max resampling, and PCM sample-format
// conversion for the streaming data loader. FFT-based ops (resample,
// cross-correlation) intentionally live on the device (ops/correlate.py) or
// in numpy f64 (ops/hostref.py) — re-deriving an FFT here would buy
// nothing.
//
// Exposed as a plain C ABI consumed via ctypes
// (audio_pattern_detector_tpu/native.py). All functions are
// allocation-free on the hot path: callers own every buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

#define APD_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ── BS.1770 K-weighting ─────────────────────────────────────────────

struct Biquad {
    double b0, b1, b2, a1, a2;
    double d1 = 0.0, d2 = 0.0;
    inline double step(double x) {
        const double y = b0 * x + d1;
        d1 = b1 * x - a1 * y + d2;
        d2 = b2 * x - a2 * y;
        return y;
    }
};

// RBJ audio-EQ-cookbook high shelf (G=4 dB, Q=1/sqrt(2), fc=1500 Hz).
Biquad make_shelf(double rate) {
    const double g = 4.0, q = 1.0 / std::sqrt(2.0), fc = 1500.0;
    const double a = std::pow(10.0, g / 40.0);
    const double w0 = 2.0 * M_PI * fc / rate;
    const double alpha = std::sin(w0) / (2.0 * q);
    const double cw = std::cos(w0);
    const double tsa = 2.0 * std::sqrt(a) * alpha;
    const double b0 = a * ((a + 1.0) + (a - 1.0) * cw + tsa);
    const double b1 = -2.0 * a * ((a - 1.0) + (a + 1.0) * cw);
    const double b2 = a * ((a + 1.0) + (a - 1.0) * cw - tsa);
    const double a0 = (a + 1.0) - (a - 1.0) * cw + tsa;
    const double a1 = 2.0 * ((a - 1.0) - (a + 1.0) * cw);
    const double a2 = (a + 1.0) - (a - 1.0) * cw - tsa;
    return Biquad{b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0};
}

// High pass (Q=0.5, fc=38 Hz).
Biquad make_highpass(double rate) {
    const double q = 0.5, fc = 38.0;
    const double w0 = 2.0 * M_PI * fc / rate;
    const double alpha = std::sin(w0) / (2.0 * q);
    const double cw = std::cos(w0);
    const double b0 = (1.0 + cw) / 2.0;
    const double b1 = -(1.0 + cw);
    const double b2 = (1.0 + cw) / 2.0;
    const double a0 = 1.0 + alpha;
    const double a1 = -2.0 * cw;
    const double a2 = 1.0 - alpha;
    return Biquad{b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0};
}

inline int64_t round_half_away(double x) {
    return (x >= 0.0) ? static_cast<int64_t>(std::floor(x + 0.5))
                      : static_cast<int64_t>(std::ceil(x - 0.5));
}

// ── Peak finding helpers ────────────────────────────────────────────

// Strict local maxima with plateau floor-midpoint (scipy semantics).
std::vector<int64_t> local_maxima(const float* x, int64_t n) {
    std::vector<int64_t> peaks;
    int64_t i = 1;
    while (i < n - 1) {
        if (x[i - 1] < x[i]) {
            const int64_t left = i;
            while (i + 1 < n && x[i] == x[i + 1]) ++i;
            if (i + 1 < n && x[i] > x[i + 1]) peaks.push_back((left + i) / 2);
        }
        ++i;
    }
    return peaks;
}

// Greedy tallest-first suppression; equal heights break toward the lower
// index (the reference helper's priority order).
void distance_filter(const float* x, std::vector<int64_t>& peaks, int64_t min_distance) {
    if (peaks.empty() || min_distance <= 0) return;
    const size_t n = peaks.size();
    std::vector<size_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        const float ha = x[peaks[a]], hb = x[peaks[b]];
        if (ha != hb) return ha > hb;
        return a < b;
    });
    std::vector<char> keep(n, 1);
    for (size_t idx : order) {
        if (!keep[idx]) continue;
        for (size_t j = idx; j-- > 0;) {
            if (peaks[idx] - peaks[j] >= min_distance) break;
            keep[j] = 0;
        }
        for (size_t j = idx + 1; j < n; ++j) {
            if (peaks[j] - peaks[idx] >= min_distance) break;
            keep[j] = 0;
        }
    }
    size_t w = 0;
    for (size_t r = 0; r < n; ++r)
        if (keep[r]) peaks[w++] = peaks[r];
    peaks.resize(w);
}

// Prominence per scipy: min on each side up to the first strictly greater
// sample (or boundary); prominence = peak - max(left_min, right_min).
double prominence_of(const float* x, int64_t n, int64_t p) {
    const float pv = x[p];
    float left_min = pv;
    for (int64_t j = p - 1; j >= 0; --j) {
        if (x[j] > pv) break;
        left_min = std::min(left_min, x[j]);
    }
    float right_min = pv;
    for (int64_t j = p + 1; j < n; ++j) {
        if (x[j] > pv) break;
        right_min = std::min(right_min, x[j]);
    }
    return static_cast<double>(pv) - std::max(left_min, right_min);
}

}  // namespace

// ── Public C ABI ────────────────────────────────────────────────────

// Integrated gated loudness per ITU-R BS.1770-4 (LUFS; -inf for silence).
APD_EXPORT double apd_integrated_loudness(const float* data, int64_t n,
                                          double rate, double block_size) {
    constexpr double kOffset = -0.691;
    constexpr double kAbsGate = -70.0;
    if (n <= 0) return -std::numeric_limits<double>::infinity();

    Biquad shelf = make_shelf(rate);
    Biquad hp = make_highpass(rate);
    std::vector<double> prefix(static_cast<size_t>(n) + 1, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        const double y = hp.step(shelf.step(static_cast<double>(data[i])));
        prefix[i + 1] = prefix[i] + y * y;
    }

    const double t_g = block_size;
    const double window = t_g * rate;
    const double hop = window * 0.25;
    const double t = static_cast<double>(n) / rate;
    const int64_t num_blocks = round_half_away((t - t_g) / (t_g * 0.25)) + 1;
    if (num_blocks <= 0) {
        const double ms = prefix[n] / static_cast<double>(n);
        if (ms <= 0.0) return -std::numeric_limits<double>::infinity();
        return kOffset + 10.0 * std::log10(ms);
    }

    std::vector<double> block_ms;
    block_ms.reserve(static_cast<size_t>(num_blocks));
    for (int64_t j = 0; j < num_blocks; ++j) {
        const int64_t lo = static_cast<int64_t>(j * hop);
        const int64_t hi = std::min<int64_t>(static_cast<int64_t>(j * hop + window), n);
        if (lo >= hi) continue;
        const double ms = (prefix[hi] - prefix[lo]) / static_cast<double>(hi - lo);
        if (ms > 0.0) block_ms.push_back(ms);
    }

    double abs_sum = 0.0;
    int64_t abs_count = 0;
    for (double ms : block_ms) {
        if (kOffset + 10.0 * std::log10(ms) >= kAbsGate) {
            abs_sum += ms;
            ++abs_count;
        }
    }
    if (abs_count == 0) return -std::numeric_limits<double>::infinity();
    const double gamma_r = kOffset + 10.0 * std::log10(abs_sum / abs_count) - 10.0;

    double rel_sum = 0.0;
    int64_t rel_count = 0;
    for (double ms : block_ms) {
        const double loud = kOffset + 10.0 * std::log10(ms);
        if (loud > gamma_r && loud >= kAbsGate) {
            rel_sum += ms;
            ++rel_count;
        }
    }
    if (rel_count == 0) return -std::numeric_limits<double>::infinity();
    return kOffset + 10.0 * std::log10(rel_sum / rel_count);
}

// Order-2 IIR (biquad) in f64, bit-identical to scipy.signal.lfilter's
// direct-form II transposed recurrence (zero initial state):
//   y  = z0 + b0*x
//   z0 = z1 + b1*x - a1*y   (evaluated left to right)
//   z1 = b2*x - a2*y
// The operation ORDER matters: the framework's f64 host anchors
// (ops/hostref.py::_biquad) are pinned bit-for-bit against scipy, and
// this export lets the CLI skip the ~2 s scipy.signal import at cold
// start without changing a single output bit. Compile with
// -ffp-contract=off (csrc/Makefile) so no FMA contraction perturbs the
// rounding. Assumes a normalised filter (a0 == 1), like the callers.
APD_EXPORT void apd_biquad_f64(const double* b, const double* a,
                               const double* x, int64_t n, double* out) {
    const double b0 = b[0], b1 = b[1], b2 = b[2];
    const double a1 = a[1], a2 = a[2];
    double z0 = 0.0, z1 = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double xi = x[i];
        const double y = z0 + b0 * xi;
        z0 = z1 + b1 * xi - a1 * y;
        z1 = b2 * xi - a2 * y;
        out[i] = y;
    }
}

// Try to quantise f32 samples onto the exact int16/32768 PCM grid.
// Writes n quantised samples plus a zero tail up to `total` into out.
// Returns 1 when EVERY sample is exactly representable (the packed
// upload path may then ship int16 pairs), 0 otherwise (caller falls
// back to the f32 payload). Semantics mirror ops/packing.py::
// try_pack_pcm16: v = x*32768 in f32, round half to even, range
// [-32768, 32767], exact only when round(v) == v; NaN fails the check.
// Single pass, block-checked so the loop auto-vectorises.
APD_EXPORT int apd_pack_pcm16(const float* x, int64_t n, int64_t total,
                              int16_t* out) {
    constexpr float kScale = 32768.0f;
    constexpr int64_t kBlock = 8192;
    for (int64_t base = 0; base < n; base += kBlock) {
        const int64_t hi = std::min(n, base + kBlock);
        int ok = 1;
        for (int64_t i = base; i < hi; ++i) {
            const float v = x[i] * kScale;
            const float q = std::nearbyintf(v);
            // q != v also catches NaN (NaN != NaN).
            ok &= static_cast<int>(q == v && q >= -32768.0f && q <= 32767.0f);
            // Clamped cast keeps the conversion defined even for the
            // out-of-range/NaN samples of a block that is about to be
            // rejected (their written values are never used).
            out[i] = static_cast<int16_t>(
                std::max(-32768.0f, std::min(32767.0f, q)));
        }
        if (!ok) return 0;
    }
    if (n < total) std::fill(out + n, out + total, static_cast<int16_t>(0));
    return 1;
}

// Gain from current to target LUFS, hard clip to [-1, 1]; NaN propagates.
APD_EXPORT void apd_loudness_normalize(const float* data, int64_t n,
                                       double current_lufs, double target_lufs,
                                       float* out) {
    const double gain = std::pow(10.0, (target_lufs - current_lufs) / 20.0);
    for (int64_t i = 0; i < n; ++i) {
        const double y = static_cast<double>(data[i]) * gain;
        if (std::isnan(y)) {
            out[i] = std::numeric_limits<float>::quiet_NaN();
        } else {
            out[i] = static_cast<float>(std::min(1.0, std::max(-1.0, y)));
        }
    }
}

// scipy.signal.find_peaks (height/distance/prominence). Returns the number
// of peaks written to out_idx, or -1 when out_cap is too small.
APD_EXPORT int64_t apd_find_peaks(const float* data, int64_t n,
                                  int use_height, double height,
                                  int use_distance, int64_t distance,
                                  int use_prominence, double prominence,
                                  int64_t* out_idx, int64_t out_cap) {
    std::vector<int64_t> peaks = local_maxima(data, n);
    if (use_height) {
        size_t w = 0;
        for (int64_t p : peaks)
            if (data[p] >= height) peaks[w++] = p;
        peaks.resize(w);
    }
    if (use_distance) distance_filter(data, peaks, distance);
    if (use_prominence) {
        size_t w = 0;
        for (int64_t p : peaks)
            if (prominence_of(data, n, p) >= prominence) peaks[w++] = p;
        peaks.resize(w);
    }
    if (static_cast<int64_t>(peaks.size()) > out_cap) return -1;
    std::copy(peaks.begin(), peaks.end(), out_idx);
    return static_cast<int64_t>(peaks.size());
}

// Pearson r with f64 accumulation; 0.0 for empty or zero variance.
APD_EXPORT double apd_pearson(const float* x, const float* y, int64_t n) {
    if (n <= 0) return 0.0;
    double mx = 0.0, my = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        mx += x[i];
        my += y[i];
    }
    mx /= n;
    my /= n;
    double cov = 0.0, vx = 0.0, vy = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double dx = x[i] - mx, dy = y[i] - my;
        cov += dx * dy;
        vx += dx * dx;
        vy += dy * dy;
    }
    const double denom = std::sqrt(vx * vy);
    if (denom == 0.0) return 0.0;
    return cov / denom;
}

// Composite Simpson 1/3 with Cartwright correction (dx = 1).
APD_EXPORT double apd_simpson(const double* y, int64_t n) {
    if (n < 2) return 0.0;
    if (n == 2) return (y[0] + y[1]) / 2.0;
    auto simpson13 = [](const double* v, int64_t k) {
        double s = v[0] + v[k - 1];
        for (int64_t i = 1; i < k - 1; i += 2) s += 4.0 * v[i];
        for (int64_t i = 2; i < k - 1; i += 2) s += 2.0 * v[i];
        return s / 3.0;
    };
    if (n % 2 == 1) return simpson13(y, n);
    const double base = simpson13(y, n - 1);
    return base + (5.0 / 12.0) * y[n - 1] + (8.0 / 12.0) * y[n - 2] -
           (1.0 / 12.0) * y[n - 3];
}

// Window-max resample; out must hold target_len floats.
APD_EXPORT void apd_resample_preserve_maxima(const float* x, int64_t n,
                                             float* out, int64_t target_len) {
    if (n <= 0 || target_len <= 0) return;
    const double step = static_cast<double>(n) / static_cast<double>(target_len);
    for (int64_t i = 0; i < target_len; ++i) {
        int64_t lo = static_cast<int64_t>(i * step);
        int64_t hi = static_cast<int64_t>((i + 1) * step);
        if (hi <= lo) hi = lo + 1;
        lo = std::min(lo, n - 1);
        hi = std::min(hi, n);
        float m = x[lo];
        for (int64_t j = lo + 1; j < hi; ++j) m = std::max(m, x[j]);
        out[i] = m;
    }
}

// ── PCM conversion (streaming data loader hot path) ─────────────────

// int16 interleaved -> float32 mono mean-mix. frames = samples per channel.
APD_EXPORT void apd_pcm16_to_f32_mono(const int16_t* in, int64_t frames,
                                      int channels, float* out) {
    const float scale = 1.0f / 32768.0f;
    if (channels == 1) {
        for (int64_t i = 0; i < frames; ++i) out[i] = in[i] * scale;
        return;
    }
    const float cscale = scale / channels;
    for (int64_t i = 0; i < frames; ++i) {
        int32_t acc = 0;
        for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
        out[i] = acc * cscale;
    }
}

// int32 interleaved -> float32 mono mean-mix.
// Mono matches the stream wrappers' numpy decode BITWISE: cast each
// sample to f32 FIRST (rounding magnitudes past 2^24 exactly as numpy's
// astype does), then scale in f32 — a double-precision product would
// differ by 1 ulp near full scale (e.g. 0x7FFFFFFF: f32-cast path gives
// exactly 1.0, the double path 0x1.fffffffp-1).
APD_EXPORT void apd_pcm32_to_f32_mono(const int32_t* in, int64_t frames,
                                      int channels, float* out) {
    const float scale = 1.0f / 2147483648.0f;
    if (channels == 1) {
        for (int64_t i = 0; i < frames; ++i)
            out[i] = static_cast<float>(in[i]) * scale;
        return;
    }
    const double cscale = 1.0 / (2147483648.0 * channels);
    for (int64_t i = 0; i < frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
        out[i] = static_cast<float>(acc * cscale);
    }
}

// ABI version for the ctypes loader.
APD_EXPORT int64_t apd_abi_version(void) { return 1; }
