/* The tests' WebP writer: the encoder settings that neither cv2 nor PIL
 * exposes (loop filter type, strength and sharpness, token partitions,
 * segments, alpha compression and filtering, lossless method and
 * near-lossless), through the system's libwebp.  make_fixtures.py builds it
 * with gcc; the port never uses it.
 *
 *     webp_writer IN.raw WIDTH HEIGHT CHANNELS OUT.webp [key=value ...]
 *
 * IN.raw holds WIDTH x HEIGHT pixels of CHANNELS (3: RGB, 4: RGBA) bytes;
 * each key is a WebPConfig field of the same name (quality a float).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

static int set(WebPConfig* c, const char* key, const char* value) {
    const int v = atoi(value);
#define FIELD(name) if (!strcmp(key, #name)) { c->name = v; return 1; }
    if (!strcmp(key, "quality")) { c->quality = (float)atof(value); return 1; }
    FIELD(lossless) FIELD(method) FIELD(segments) FIELD(sns_strength) FIELD(filter_strength)
    FIELD(filter_sharpness) FIELD(filter_type) FIELD(autofilter) FIELD(alpha_compression)
    FIELD(alpha_filtering) FIELD(alpha_quality) FIELD(pass) FIELD(preprocessing)
    FIELD(partitions) FIELD(partition_limit) FIELD(near_lossless) FIELD(exact)
    FIELD(use_sharp_yuv)
#undef FIELD
    return 0;
}

int main(int argc, char** argv) {
    if (argc < 6) {
        fprintf(stderr, "usage: %s IN.raw W H CHANNELS OUT.webp [key=value ...]\n", argv[0]);
        return 2;
    }
    const int w = atoi(argv[2]), h = atoi(argv[3]), ch = atoi(argv[4]);
    unsigned char* px = malloc((size_t)w * h * ch);
    FILE* f = fopen(argv[1], "rb");
    if (!f || fread(px, 1, (size_t)w * h * ch, f) != (size_t)w * h * ch) return 3;
    fclose(f);
    WebPConfig config;
    if (!WebPConfigInit(&config)) return 4;
    for (int i = 6; i < argc; ++i) {
        char* eq = strchr(argv[i], '=');
        if (!eq) return 5;
        *eq = 0;
        if (!set(&config, argv[i], eq + 1)) {
            fprintf(stderr, "unknown setting %s\n", argv[i]);
            return 5;
        }
    }
    if (!WebPValidateConfig(&config)) return 6;
    WebPPicture pic;
    if (!WebPPictureInit(&pic)) return 7;
    pic.width = w;
    pic.height = h;
    pic.use_argb = config.lossless;
    if (!(ch == 4 ? WebPPictureImportRGBA(&pic, px, w * 4) : WebPPictureImportRGB(&pic, px, w * 3)))
        return 8;
    WebPMemoryWriter wr;
    WebPMemoryWriterInit(&wr);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &wr;
    if (!WebPEncode(&config, &pic)) {
        fprintf(stderr, "encode failed: %d\n", pic.error_code);
        return 9;
    }
    FILE* out = fopen(argv[5], "wb");
    if (!out || fwrite(wr.mem, 1, wr.size, out) != wr.size) return 10;
    fclose(out);
    WebPMemoryWriterClear(&wr);
    WebPPictureFree(&pic);
    free(px);
    return 0;
}
