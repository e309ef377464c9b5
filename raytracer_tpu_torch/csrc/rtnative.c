/* rtnative: the host-side runtime library of raytracer_tpu_torch.
 *
 * The work the reference's runtime also did natively on the host:
 *
 *   - PNG scanline unfiltering (the hot loop of asset decode; the reference
 *     links libpng, src/assets.cc:11-58); pngio.py falls back to its
 *     Python loop when the library is not built.
 *   - Perlin terrain field evaluation (reference src/procedural/perlin.cu),
 *     float32 operation for operation as perlin.py, reversed lerp included.
 *   - 64-bit Morton codes of float bit patterns (reference z_order.cu).
 *
 * A copy of native/rtnative.c.  native.py builds it as a plain C shared
 * library with the host compiler (-O3 -fPIC -shared -ffp-contract=off -lm:
 * no contracted FMA, so the Perlin loop rounds as perlin.py does) and
 * binds it with ctypes.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------- PNG unfiltering (RFC 2083 filters 0-4) ---------------- */

static uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
    int p = (int)a + (int)b - (int)c;
    int pa = abs(p - (int)a), pb = abs(p - (int)b), pc = abs(p - (int)c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

/* raw: height*(1+stride) filtered bytes; out: height*stride unfiltered. */
int rt_png_unfilter(const uint8_t* raw, uint8_t* out, long height, long stride,
                    long bpp) {
    const uint8_t* prev = NULL;
    for (long y = 0; y < height; y++) {
        uint8_t ftype = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* dst = out + y * stride;
        switch (ftype) {
            case 0:
                memcpy(dst, line, stride);
                break;
            case 1:
                for (long x = 0; x < stride; x++) {
                    uint8_t left = x >= bpp ? dst[x - bpp] : 0;
                    dst[x] = (uint8_t)(line[x] + left);
                }
                break;
            case 2:
                for (long x = 0; x < stride; x++) {
                    uint8_t up = prev ? prev[x] : 0;
                    dst[x] = (uint8_t)(line[x] + up);
                }
                break;
            case 3:
                for (long x = 0; x < stride; x++) {
                    uint8_t left = x >= bpp ? dst[x - bpp] : 0;
                    uint8_t up = prev ? prev[x] : 0;
                    dst[x] = (uint8_t)(line[x] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (long x = 0; x < stride; x++) {
                    uint8_t left = x >= bpp ? dst[x - bpp] : 0;
                    uint8_t up = prev ? prev[x] : 0;
                    uint8_t ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    dst[x] = (uint8_t)(line[x] + paeth(left, up, ul));
                }
                break;
            default:
                return -1;
        }
        prev = dst;
    }
    return 0;
}

/* ---------------- Perlin field (f32-faithful to perlin.py) --------------- */

typedef struct {
    const float* sample_vecs; /* [n][3] */
    const int32_t* permutation;
    int32_t n;
    float amplitude;
    float period;
} rt_perlin;

static const float* perlin_hash(const rt_perlin* p, long x, long y, long z) {
    long n = p->n;
    long hx = x % n;
    long hxy = (p->permutation[hx] + y) % n;
    long hxyz = (p->permutation[hxy] + z) % n;
    return p->sample_vecs + 3 * p->permutation[hxyz];
}

static float smoothstep_remap(float d) {
    return d * d * (3.0f - 2.0f * d);
}

static float gen_weight(const rt_perlin* p, long ix, long iy, long iz,
                        float mx, float my, float mz, int dx, int dy, int dz) {
    float ox = (float)dx - mx, oy = (float)dy - my, oz = (float)dz - mz;
    float len = sqrtf(ox * ox + oy * oy + oz * oz);
    if (len > 1e-5f) {
        float inv = 1.0f / len;
        ox *= inv; oy *= inv; oz *= inv;
    } else {
        ox = oy = oz = 0.0f;
    }
    const float* wv = perlin_hash(p, ix + dx, iy + dy, iz + dz);
    return wv[0] * ox + wv[1] * oy + wv[2] * oz;
}

/* interpolate(a, b, w) = w*a + (1-w)*b — the reference's REVERSED lerp
 * (perlin.cu:8-10), preserved bit-for-bit. */
static float interp(float a, float b, float w) {
    return w * a + (1.0f - w) * b;
}

float rt_perlin_sample(const rt_perlin* p, float x, float y, float z) {
    float sx = x * (float)p->n / p->period;
    float sy = y * (float)p->n / p->period;
    float sz = z * (float)p->n / p->period;
    long ix = ((long)floorf(sx)) % p->n;
    long iy = ((long)floorf(sy)) % p->n;
    long iz = ((long)floorf(sz)) % p->n;
    float mx = smoothstep_remap(sx - floorf(sx));
    float my = smoothstep_remap(sy - floorf(sy));
    float mz = smoothstep_remap(sz - floorf(sz));

    float w000 = gen_weight(p, ix, iy, iz, mx, my, mz, 0, 0, 0);
    float w001 = gen_weight(p, ix, iy, iz, mx, my, mz, 0, 0, 1);
    float w010 = gen_weight(p, ix, iy, iz, mx, my, mz, 0, 1, 0);
    float w011 = gen_weight(p, ix, iy, iz, mx, my, mz, 0, 1, 1);
    float w100 = gen_weight(p, ix, iy, iz, mx, my, mz, 1, 0, 0);
    float w101 = gen_weight(p, ix, iy, iz, mx, my, mz, 1, 0, 1);
    float w110 = gen_weight(p, ix, iy, iz, mx, my, mz, 1, 1, 0);
    float w111 = gen_weight(p, ix, iy, iz, mx, my, mz, 1, 1, 1);

    float x00 = interp(w000, w100, mx);
    float x01 = interp(w001, w101, mx);
    float x10 = interp(w010, w110, mx);
    float x11 = interp(w011, w111, mx);
    float xy0 = interp(x00, x10, my);
    float xy1 = interp(x01, x11, my);
    float xyz = interp(xy0, xy1, mz);
    return p->amplitude * xyz;
}

/* Batch terrain heights: y_off = floor(0.5*(sample(i,j,0)+amplitude)) + 1 for
 * an entire grid (the cube_world.cc:155-167 inner loop). */
void rt_perlin_grid_yoff(const float* sample_vecs, const int32_t* permutation,
                         int32_t n, float amplitude, float period,
                         int32_t grid, float* out_yoff) {
    rt_perlin p = {sample_vecs, permutation, n, amplitude, period};
    for (int32_t i = 0; i < grid; i++) {
        for (int32_t j = 0; j < grid; j++) {
            float s = rt_perlin_sample(&p, (float)i, (float)j, 0.0f);
            out_yoff[i * grid + j] = floorf(0.5f * (s + amplitude)) + 1.0f;
        }
    }
}

/* ---------------- Morton / z-order (reference z_order.cu:5-36) ----------- */

uint64_t rt_z_order_f32bits(float cx, float cy, float cz) {
    float inv[3] = {-cx, -cy, -cz};
    uint32_t bits[3];
    memcpy(bits, inv, sizeof(bits));
    int offs[3] = {31, 31, 31};
    uint64_t t = 0;
    for (int i = 0; i < 64; i++) {
        t <<= 1;
        int sel = i % 3;
        t |= (bits[sel] >> offs[sel]) & 1u;
        offs[sel] -= 1;
    }
    return t;
}

void rt_z_order_batch(const float* centers, long n, uint64_t* out) {
    for (long i = 0; i < n; i++) {
        out[i] = rt_z_order_f32bits(centers[3 * i], centers[3 * i + 1],
                                    centers[3 * i + 2]);
    }
}
