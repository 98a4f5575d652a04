/* The JPEG 2000 fixtures' writer of the settings neither cv2 nor PIL
 * exposes: code-block styles, ROI, SOP / EPH, POC, tile-parts, TLM,
 * component subsampling, precisions other than 8 and 16.  It calls the
 * system's OpenJPEG (libopenjp2.so.7, 2.5) through its public API, whose
 * declarations are repeated here, so that no OpenJPEG header is needed.
 * Fixtures only: the port's decoder never uses it.
 *
 *     gcc -O2 j2k_writer.c -l:libopenjp2.so.7 -o j2k_writer
 *     j2k_writer in.raw WIDTH HEIGHT COMPONENTS out.j2k [key=value ...]
 *
 * in.raw: the samples, interleaved, one byte each (two, native order, when
 * prec > 8).  Keys: jp2 (0 / 1), prec, sgnd, irreversible, mct, numres,
 * cblk (WxH), prc (WxH, all levels), prog (LRCP ... CPRL), tile (WxH),
 * tileoff (XxY), offset (XxY), rates (r1,r2,..., a rate of 0 lossless),
 * mode (code-block style bits), csty (SOP 2, EPH 4), roi (comp,shift),
 * poc (tile:res0:comp0:lay1:res1:comp1:order, joined by '/'), tp (R, L or
 * C tile-parts), tlm (1), plt (1), sub (DXxDY for components after the
 * first).  With no keys it writes what PIL's default JPEG 2000 save does.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef int OPJ_BOOL;
typedef enum { OPJ_PROG_UNKNOWN = -1, OPJ_LRCP, OPJ_RLCP, OPJ_RPCL, OPJ_PCRL, OPJ_CPRL } OPJ_PROG_ORDER;
typedef enum { OPJ_CLRSPC_UNKNOWN = -1, OPJ_CLRSPC_UNSPECIFIED, OPJ_CLRSPC_SRGB, OPJ_CLRSPC_GRAY,
               OPJ_CLRSPC_SYCC } OPJ_COLOR_SPACE;

typedef struct {
    uint32_t resno0, compno0, layno1, resno1, compno1, layno0, precno0, precno1;
    OPJ_PROG_ORDER prg1, prg;
    char progorder[5];
    uint32_t tile;
    int32_t tx0, tx1, ty0, ty1;
    uint32_t layS, resS, compS, prcS, layE, resE, compE, prcE;
    uint32_t txS, txE, tyS, tyE, dx, dy;
    uint32_t lay_t, res_t, comp_t, prc_t, tx0_t, ty0_t;
} opj_poc_t;

typedef struct {
    OPJ_BOOL tile_size_on;
    int cp_tx0, cp_ty0, cp_tdx, cp_tdy;
    int cp_disto_alloc, cp_fixed_alloc, cp_fixed_quality;
    int *cp_matrice;
    char *cp_comment;
    int csty;
    OPJ_PROG_ORDER prog_order;
    opj_poc_t POC[32];
    uint32_t numpocs;
    int tcp_numlayers;
    float tcp_rates[100];
    float tcp_distoratio[100];
    int numresolution, cblockw_init, cblockh_init, mode, irreversible, roi_compno, roi_shift;
    int res_spec;
    int prcw_init[33], prch_init[33];
    char infile[4096], outfile[4096];
    int index_on;
    char index[4096];
    int image_offset_x0, image_offset_y0, subsampling_dx, subsampling_dy, decod_format,
        cod_format;
    OPJ_BOOL jpwl_epc_on;
    int jpwl_hprot_MH, jpwl_hprot_TPH_tileno[16], jpwl_hprot_TPH[16], jpwl_pprot_tileno[16],
        jpwl_pprot_packno[16], jpwl_pprot[16], jpwl_sens_size, jpwl_sens_addr, jpwl_sens_range,
        jpwl_sens_MH, jpwl_sens_TPH_tileno[16], jpwl_sens_TPH[16];
    int cp_cinema, max_comp_size, cp_rsiz;
    char tp_on, tp_flag, tcp_mct;
    OPJ_BOOL jpip_on;
    void *mct_data;
    int max_cs_size;
    uint16_t rsiz;
} opj_cparameters_t;

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd;
} opj_image_cmptparm_t;

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
    int32_t *data;
    uint16_t alpha;
} opj_image_comp_t;

typedef struct {
    uint32_t x0, y0, x1, y1, numcomps;
    OPJ_COLOR_SPACE color_space;
    opj_image_comp_t *comps;
    unsigned char *icc_profile_buf;
    uint32_t icc_profile_len;
} opj_image_t;

typedef void opj_codec_t;
typedef void opj_stream_t;
typedef void (*opj_msg_callback)(const char *msg, void *client_data);

extern void opj_set_default_encoder_parameters(opj_cparameters_t *);
extern opj_image_t *opj_image_create(uint32_t, opj_image_cmptparm_t *, OPJ_COLOR_SPACE);
extern void opj_image_destroy(opj_image_t *);
extern opj_codec_t *opj_create_compress(int format);
extern OPJ_BOOL opj_setup_encoder(opj_codec_t *, opj_cparameters_t *, opj_image_t *);
extern OPJ_BOOL opj_encoder_set_extra_options(opj_codec_t *, const char *const *);
extern opj_stream_t *opj_stream_create_default_file_stream(const char *, OPJ_BOOL);
extern OPJ_BOOL opj_start_compress(opj_codec_t *, opj_image_t *, opj_stream_t *);
extern OPJ_BOOL opj_encode(opj_codec_t *, opj_stream_t *);
extern OPJ_BOOL opj_end_compress(opj_codec_t *, opj_stream_t *);
extern void opj_stream_destroy(opj_stream_t *);
extern void opj_destroy_codec(opj_codec_t *);
extern OPJ_BOOL opj_set_error_handler(opj_codec_t *, opj_msg_callback, void *);

static void on_error(const char *msg, void *data) {
    (void)data;
    fprintf(stderr, "openjpeg: %s", msg);
}

static OPJ_PROG_ORDER order(const char *s) {
    const char *names[] = {"LRCP", "RLCP", "RPCL", "PCRL", "CPRL"};
    for (int i = 0; i < 5; ++i)
        if (!strcmp(s, names[i])) return (OPJ_PROG_ORDER)i;
    fprintf(stderr, "unknown progression %s\n", s);
    exit(2);
}

int main(int argc, char **argv) {
    if (argc < 6) {
        fprintf(stderr, "usage: %s in.raw W H C out [key=value ...]\n", argv[0]);
        return 2;
    }
    const int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
    /* the library's struct may be larger than the declaration above */
    static union { opj_cparameters_t p; char pad[1 << 16]; } u;
    opj_cparameters_t *prm = &u.p;
    opj_set_default_encoder_parameters(prm);
    int jp2 = 0, prec = 8, sgnd = 0, dx = 1, dy = 1, tlm = 0, plt = 0, have_numres = 0;
    int tile_w = w, tile_h = h;
    for (int i = 6; i < argc; ++i) {
        char key[32], val[512];
        if (sscanf(argv[i], "%31[^=]=%511s", key, val) != 2) return 2;
        if (!strcmp(key, "jp2")) jp2 = atoi(val);
        else if (!strcmp(key, "prec")) prec = atoi(val);
        else if (!strcmp(key, "sgnd")) sgnd = atoi(val);
        else if (!strcmp(key, "irreversible")) prm->irreversible = atoi(val);
        else if (!strcmp(key, "mct")) prm->tcp_mct = (char)atoi(val);
        else if (!strcmp(key, "numres")) { prm->numresolution = atoi(val); have_numres = 1; }
        else if (!strcmp(key, "cblk")) sscanf(val, "%dx%d", &prm->cblockw_init, &prm->cblockh_init);
        else if (!strcmp(key, "prc")) {
            int pw, ph;
            sscanf(val, "%dx%d", &pw, &ph);
            prm->prcw_init[0] = pw;
            prm->prch_init[0] = ph;
            prm->res_spec = 1;
            prm->csty |= 0x01;
        } else if (!strcmp(key, "prog")) prm->prog_order = order(val);
        else if (!strcmp(key, "tile")) {
            sscanf(val, "%dx%d", &prm->cp_tdx, &prm->cp_tdy);
            prm->tile_size_on = 1;
            tile_w = prm->cp_tdx;
            tile_h = prm->cp_tdy;
        } else if (!strcmp(key, "tileoff")) sscanf(val, "%dx%d", &prm->cp_tx0, &prm->cp_ty0);
        else if (!strcmp(key, "offset"))
            sscanf(val, "%dx%d", &prm->image_offset_x0, &prm->image_offset_y0);
        else if (!strcmp(key, "rates")) {
            char *s = val;
            prm->tcp_numlayers = 0;
            for (char *t = strtok(s, ","); t; t = strtok(NULL, ","))
                prm->tcp_rates[prm->tcp_numlayers++] = (float)atof(t);
            prm->cp_disto_alloc = 1;
        } else if (!strcmp(key, "mode")) prm->mode = atoi(val);
        else if (!strcmp(key, "csty")) prm->csty |= atoi(val);
        else if (!strcmp(key, "roi")) sscanf(val, "%d,%d", &prm->roi_compno, &prm->roi_shift);
        else if (!strcmp(key, "poc")) {
            for (char *t = strtok(val, "/"); t; t = strtok(NULL, "/")) {
                opj_poc_t *c = &prm->POC[prm->numpocs++];
                char ord[8];
                sscanf(t, "%u:%u:%u:%u:%u:%u:%7s", &c->tile, &c->resno0, &c->compno0, &c->layno1,
                       &c->resno1, &c->compno1, ord);
                c->prg1 = order(ord);
            }
        } else if (!strcmp(key, "tp")) { prm->tp_on = 1; prm->tp_flag = val[0]; }
        else if (!strcmp(key, "tlm")) tlm = atoi(val);
        else if (!strcmp(key, "plt")) plt = atoi(val);
        else if (!strcmp(key, "sub")) sscanf(val, "%dx%d", &dx, &dy);
        else { fprintf(stderr, "unknown key %s\n", key); return 2; }
    }
    if (!have_numres) /* as PIL: as many levels as the tile's sides allow */
        while (tile_w < (1 << (prm->numresolution - 1)) || tile_h < (1 << (prm->numresolution - 1)))
            prm->numresolution -= 1;

    opj_image_cmptparm_t cp[16];
    memset(cp, 0, sizeof cp);
    for (int c = 0; c < nc; ++c) {
        cp[c].dx = c ? dx : 1;
        cp[c].dy = c ? dy : 1;
        cp[c].x0 = prm->image_offset_x0;
        cp[c].y0 = prm->image_offset_y0;
        cp[c].w = (w + cp[c].dx - 1) / cp[c].dx;
        cp[c].h = (h + cp[c].dy - 1) / cp[c].dy;
        cp[c].prec = prec;
        cp[c].bpp = prec;
        cp[c].sgnd = sgnd;
    }
    opj_image_t *img = opj_image_create(nc, cp, nc >= 3 ? OPJ_CLRSPC_SRGB : OPJ_CLRSPC_GRAY);
    img->x0 = prm->image_offset_x0;
    img->y0 = prm->image_offset_y0;
    img->x1 = img->x0 + w;
    img->y1 = img->y0 + h;
    FILE *f = fopen(argv[1], "rb");
    const int bytes = prec > 8 ? 2 : 1;
    unsigned char *raw = malloc((size_t)w * h * nc * bytes);
    if (!f || fread(raw, bytes, (size_t)w * h * nc, f) != (size_t)w * h * nc) return 1;
    fclose(f);
    for (int c = 0; c < nc; ++c)
        for (uint32_t y = 0; y < img->comps[c].h; ++y)
            for (uint32_t x = 0; x < img->comps[c].w; ++x) {
                size_t k = ((size_t)(y * img->comps[c].dy) * w + x * img->comps[c].dx) * nc + c;
                int v = bytes == 2 ? ((uint16_t *)raw)[k] : raw[k];
                if (sgnd) v -= 1 << (prec - 1);
                img->comps[c].data[y * img->comps[c].w + x] = v;
            }
    if (nc == 2 || nc == 4) img->comps[nc - 1].alpha = 1;

    opj_codec_t *codec = opj_create_compress(jp2 ? 2 : 0);
    opj_set_error_handler(codec, on_error, NULL);
    const char *opts[3] = {NULL, NULL, NULL};
    int n = 0;
    if (tlm) opts[n++] = "TLM=YES";
    if (plt) opts[n++] = "PLT=YES";
    if (n && !opj_encoder_set_extra_options(codec, opts)) return 1;
    if (!opj_setup_encoder(codec, prm, img)) return 1;
    opj_stream_t *st = opj_stream_create_default_file_stream(argv[5], 0);
    if (!st || !opj_start_compress(codec, img, st) || !opj_encode(codec, st) ||
        !opj_end_compress(codec, st))
        return 1;
    opj_stream_destroy(st);
    opj_destroy_codec(codec);
    opj_image_destroy(img);
    free(raw);
    return 0;
}
