// Native EXR reader for compressions the pure-Python path doesn't
// decode (PIZ, PXR24, B44, DWA...).  The reference reads every EXR
// through OpenEXR (src/core/imageio.cpp:124+); this shim does the same
// against the system OpenEXR 3.1, exposed over a C ABI for ctypes
// (native/build.py::read_exr_native; a copy of pbrt_tpu's shim).
// RgbaInputFile handles every compression and channel layout (RGB, RGBA,
// luminance) and converts to half RGBA.
#include <ImfRgbaFile.h>
#include <ImfArray.h>

extern "C" {

// returns 0 on success and fills w/h; -1 on failure
int pbrt_exr_size(const char *path, int *w, int *h) {
    try {
        Imf::RgbaInputFile file(path);
        auto dw = file.dataWindow();
        *w = dw.max.x - dw.min.x + 1;
        *h = dw.max.y - dw.min.y + 1;
        return 0;
    } catch (...) {
        return -1;
    }
}

// out must hold w*h*4 floats (RGBA, scanline order); returns 0/-1
int pbrt_exr_read_rgba(const char *path, float *out) {
    try {
        Imf::RgbaInputFile file(path);
        auto dw = file.dataWindow();
        int w = dw.max.x - dw.min.x + 1;
        int h = dw.max.y - dw.min.y + 1;
        Imf::Array2D<Imf::Rgba> px(h, w);
        file.setFrameBuffer(&px[0][0] - dw.min.x - dw.min.y * w, 1, w);
        file.readPixels(dw.min.y, dw.max.y);
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const Imf::Rgba &p = px[y][x];
                float *o = out + 4 * (y * (long)w + x);
                o[0] = p.r;
                o[1] = p.g;
                o[2] = p.b;
                o[3] = p.a;
            }
        }
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
