// Host-side kernels of the training data pipeline: the photometric chain
// and the eraser fill (the port's own copy of
// raft_stereo_tpu/native/augment.cpp:67 and :177, unchanged, so the
// port's augmentation equals the JAX package's bit for bit).
//
// fused_photometric fuses brightness, contrast, saturation, hue and gamma
// (torchvision ColorJitter semantics, reference core/utils/augmentor.py:78)
// into one pass over an interleaved RGB u8 image, in place; eraser_fill
// paints mean-colour rectangles (reference augmentor.py:98-111). Called
// through ctypes, which releases the GIL for each call, so the loader's
// threads overlap.
//
// Built at first use by raft_stereo_tpu_torch/native/__init__.py with the
// host compiler: g++ -O3 -fPIC -shared -std=c++17 -Wall.

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- color

static inline float clampf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// RGB [0,255] -> HSV (h in [0,360), s,v in [0,1])
static inline void rgb2hsv(float r, float g, float b, float* h, float* s, float* v) {
    r /= 255.f; g /= 255.f; b /= 255.f;
    float mx = std::max(r, std::max(g, b));
    float mn = std::min(r, std::min(g, b));
    float d = mx - mn;
    *v = mx;
    *s = mx > 0.f ? d / mx : 0.f;
    if (d <= 0.f) { *h = 0.f; return; }
    float hh;
    if (mx == r)      hh = fmodf((g - b) / d, 6.f);
    else if (mx == g) hh = (b - r) / d + 2.f;
    else              hh = (r - g) / d + 4.f;
    hh *= 60.f;
    if (hh < 0.f) hh += 360.f;
    *h = hh;
}

static inline void hsv2rgb(float h, float s, float v, float* r, float* g, float* b) {
    float c = v * s;
    float x = c * (1.f - fabsf(fmodf(h / 60.f, 2.f) - 1.f));
    float m = v - c;
    float rr, gg, bb;
    if (h < 60)       { rr = c; gg = x; bb = 0; }
    else if (h < 120) { rr = x; gg = c; bb = 0; }
    else if (h < 180) { rr = 0; gg = c; bb = x; }
    else if (h < 240) { rr = 0; gg = x; bb = c; }
    else if (h < 300) { rr = x; gg = 0; bb = c; }
    else              { rr = c; gg = 0; bb = x; }
    *r = (rr + m) * 255.f;
    *g = (gg + m) * 255.f;
    *b = (bb + m) * 255.f;
}

// Fused photometric chain, in place on interleaved RGB u8.
// Order matches the numpy path (data/augmentor.py): brightness, contrast,
// saturation, hue, gamma. ITU-R 601 luma for contrast/saturation gray.
void fused_photometric(uint8_t* img, int64_t n_pixels,
                       float brightness, float contrast, float saturation,
                       float hue_shift_deg, float gamma, float gain) {
    // pass 1: grayscale mean after brightness (contrast blends toward the
    // mean of the *brightness-adjusted* grayscale image)
    double gray_sum = 0.0;
    for (int64_t i = 0; i < n_pixels; ++i) {
        float r = clampf(img[3 * i + 0] * brightness, 0.f, 255.f);
        float g = clampf(img[3 * i + 1] * brightness, 0.f, 255.f);
        float b = clampf(img[3 * i + 2] * brightness, 0.f, 255.f);
        gray_sum += 0.299f * r + 0.587f * g + 0.114f * b;
    }
    float gray_mean = (float)(gray_sum / (double)n_pixels);

    float inv_gamma_scale = 1.f / 255.f;
    for (int64_t i = 0; i < n_pixels; ++i) {
        float r = clampf(img[3 * i + 0] * brightness, 0.f, 255.f);
        float g = clampf(img[3 * i + 1] * brightness, 0.f, 255.f);
        float b = clampf(img[3 * i + 2] * brightness, 0.f, 255.f);
        // contrast
        r = clampf(r * contrast + gray_mean * (1.f - contrast), 0.f, 255.f);
        g = clampf(g * contrast + gray_mean * (1.f - contrast), 0.f, 255.f);
        b = clampf(b * contrast + gray_mean * (1.f - contrast), 0.f, 255.f);
        // saturation: blend with per-pixel gray
        float gray = 0.299f * r + 0.587f * g + 0.114f * b;
        r = clampf(r * saturation + gray * (1.f - saturation), 0.f, 255.f);
        g = clampf(g * saturation + gray * (1.f - saturation), 0.f, 255.f);
        b = clampf(b * saturation + gray * (1.f - saturation), 0.f, 255.f);
        // hue rotation
        if (hue_shift_deg != 0.f) {
            float h, s, v;
            rgb2hsv(r, g, b, &h, &s, &v);
            h = fmodf(h + hue_shift_deg + 360.f, 360.f);
            hsv2rgb(h, s, v, &r, &g, &b);
        }
        // gamma
        if (gamma != 1.f || gain != 1.f) {
            r = clampf(255.f * gain * powf(r * inv_gamma_scale, gamma), 0.f, 255.f);
            g = clampf(255.f * gain * powf(g * inv_gamma_scale, gamma), 0.f, 255.f);
            b = clampf(255.f * gain * powf(b * inv_gamma_scale, gamma), 0.f, 255.f);
        }
        img[3 * i + 0] = (uint8_t)(r + 0.5f);
        img[3 * i + 1] = (uint8_t)(g + 0.5f);
        img[3 * i + 2] = (uint8_t)(b + 0.5f);
    }
}

// ---------------------------------------------------------------- eraser

// Mean-color rectangle fill (occlusion eraser, reference augmentor.py:98-111)
void eraser_fill(uint8_t* img, int64_t h, int64_t w,
                 const float* mean_color,
                 const int64_t* rects, int64_t n_rects) {
    for (int64_t r = 0; r < n_rects; ++r) {
        int64_t x0 = rects[4 * r + 0], y0 = rects[4 * r + 1];
        int64_t dx = rects[4 * r + 2], dy = rects[4 * r + 3];
        int64_t x1 = std::min(x0 + dx, w), y1 = std::min(y0 + dy, h);
        for (int64_t y = y0; y < y1; ++y)
            for (int64_t x = x0; x < x1; ++x)
                for (int64_t c = 0; c < 3; ++c)
                    img[(y * w + x) * 3 + c] = (uint8_t)(mean_color[c] + 0.5f);
    }
}

}  // extern "C"
