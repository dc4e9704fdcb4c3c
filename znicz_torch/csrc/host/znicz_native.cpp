// znicz_native: the port's host runtime (its own copy of the reference's
// host C++ source; the port reads nothing outside its package).
//
// The host data path in C++, exposed as a plain C ABI through ctypes
// (znicz_torch/native.py):
//
//   - xorshift128+ PRNG with a splitmix64 seed expansion: the loader's
//     native_shuffle and host-side fills;
//   - Fisher-Yates shuffling of an int32 index row;
//   - batched row gather (minibatch assembly for host-resident data);
//   - u8 -> f32 scale/shift decode (the image loader).
//
// The same source with the same flags gives the reference's draws bit for
// bit.  Build: g++ -O3 -shared -fPIC -std=c++17 (native.py does it at
// first use into build/host/).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// ---- xorshift128+ (state: 2x uint64, caller-owned) -------------------------

static inline uint64_t xs128p_next(uint64_t *s) {
    uint64_t s1 = s[0];
    const uint64_t s0 = s[1];
    const uint64_t result = s0 + s1;
    s[0] = s0;
    s1 ^= s1 << 23;
    s[1] = s1 ^ s0 ^ (s1 >> 18) ^ (s0 >> 5);
    return result;
}

void znicz_seed(uint64_t *state, uint64_t seed) {
    // splitmix64 expansion (never leave the state all-zero)
    uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
    for (int i = 0; i < 2; ++i) {
        z += 0x9E3779B97F4A7C15ULL;
        uint64_t x = z;
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
        x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
        state[i] = x ^ (x >> 31);
    }
    if (state[0] == 0 && state[1] == 0) state[0] = 1;
}

void znicz_fill_uniform(uint64_t *state, float *out, size_t n,
                        float low, float high) {
    const float span = high - low;
    for (size_t i = 0; i < n; ++i) {
        // 53-bit mantissa trick -> double in [0,1)
        const double u = (double)(xs128p_next(state) >> 11) * 0x1.0p-53;
        out[i] = low + (float)u * span;
    }
}

void znicz_fill_normal(uint64_t *state, float *out, size_t n, float stddev) {
    // Box-Muller, pairwise
    size_t i = 0;
    while (i < n) {
        double u1 = (double)(xs128p_next(state) >> 11) * 0x1.0p-53;
        double u2 = (double)(xs128p_next(state) >> 11) * 0x1.0p-53;
        if (u1 < 1e-300) u1 = 1e-300;
        const double r = std::sqrt(-2.0 * std::log(u1));
        out[i++] = (float)(r * std::cos(2.0 * M_PI * u2)) * stddev;
        if (i < n)
            out[i++] = (float)(r * std::sin(2.0 * M_PI * u2)) * stddev;
    }
}

void znicz_shuffle_i32(uint64_t *state, int32_t *arr, size_t n) {
    if (n < 2) return;
    for (size_t i = n - 1; i > 0; --i) {
        const size_t j = (size_t)(xs128p_next(state) % (uint64_t)(i + 1));
        const int32_t t = arr[i];
        arr[i] = arr[j];
        arr[j] = t;
    }
}

// ---- minibatch assembly ----------------------------------------------------

void znicz_gather_f32(const float *src, const int32_t *idx, float *dst,
                      size_t n_rows, size_t row_elems) {
    const size_t row_bytes = row_elems * sizeof(float);
    for (size_t r = 0; r < n_rows; ++r)
        std::memcpy(dst + r * row_elems,
                    src + (size_t)idx[r] * row_elems, row_bytes);
}

void znicz_u8_to_f32(const uint8_t *src, float *dst, size_t n,
                     float scale, float shift) {
    for (size_t i = 0; i < n; ++i)
        dst[i] = (float)src[i] * scale + shift;
}

// ---- version ---------------------------------------------------------------

int znicz_native_abi(void) { return 1; }

}  // extern "C"
