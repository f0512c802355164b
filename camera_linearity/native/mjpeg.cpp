// Native MJPEG frame decoder for camera_linearity.
//
// Decodes single JFIF/JPEG images (the per-frame payload of an MJPG AVI
// stream, reference decode path: modules/general_functions.py:226-251 via
// cv2.VideoCapture) straight into caller-provided interleaved BGR uint8
// buffers using the system libjpeg(-turbo).
//
// Why this exists: cv2.VideoCapture routes .avi files through FFmpeg's
// mjpeg decoder, which produces YUVJ422P planes and then pays a separate
// YUV->BGR conversion pass.  libjpeg-turbo's merged upsample+color-convert
// SIMD path writes BGR directly from the IDCT output, skipping that pass
// entirely — decode bounds the video pipeline end to end (config 5), so the
// saved pass is directly visible in throughput.  ``fast_dct`` additionally selects
// JDCT_IFAST + plain (non-fancy) chroma upsampling; the pixel deltas vs the
// reference decoder are qualified in benchmarks/bench_decode.py.
//
// Built as its own shared library (-ljpeg) so a host without libjpeg dev
// files degrades ONLY this path; the stager library is independent.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared before inclusion

#include <jpeglib.h>

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
    ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void swallow_message(j_common_ptr) {}

}  // namespace

extern "C" {

// Decode one JPEG (bytes src[0..n)) into dst = height*width*3 interleaved
// BGR uint8.  Returns 0 on success; -1 libjpeg decode error; -2 the frame's
// geometry differs from (height, width); -3 not a 3-component image.
int clt_jpeg_decode_bgr(const unsigned char* src, std::size_t n,
                        unsigned char* dst, int height, int width,
                        int fast_dct) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = on_error;
    jerr.pub.output_message = swallow_message;  // no stderr spam per frame
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, src, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.num_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    cinfo.out_color_space = JCS_EXT_BGR;
    if (fast_dct) {
        cinfo.dct_method = JDCT_IFAST;
        cinfo.do_fancy_upsampling = FALSE;
    } else {
        cinfo.dct_method = JDCT_ISLOW;
    }
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_width) != width ||
        static_cast<int>(cinfo.output_height) != height ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    const std::size_t stride = static_cast<std::size_t>(width) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW rows[16];
        const JDIMENSION base = cinfo.output_scanline;
        int m = 0;
        while (m < 16 && base + m < cinfo.output_height) {
            rows[m] = dst + static_cast<std::size_t>(base + m) * stride;
            ++m;
        }
        jpeg_read_scanlines(&cinfo, rows, m);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int clt_mjpeg_version() { return 1; }

}  // extern "C"
