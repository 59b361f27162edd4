/* Writes the JPEG processes that PIL's encoder does not: arithmetic-coded
 * sequential and progressive DCT (SOF9, SOF10), lossless (SOF3) and 12-bit
 * samples. Built and run by tests/make_jpeg_process_fixtures.py against the
 * libjpeg-turbo that PIL bundles (the library imageio decodes with):
 *
 *   jpeg_process_writer arith IN.jpg OUT.jpg PROGRESSIVE RESTART L U K
 *     transcodes IN's quantized coefficients (no pixel changes) with
 *     arithmetic coding; PROGRESSIVE 0/1; RESTART MCUs per interval
 *     (-1: keep IN's); L, U, K the DAC conditioning of every table
 *     (0 1 5 are the defaults).
 *   jpeg_process_writer lossless IN.raw OUT.jpg W H C PREDICTOR PT ROWS
 *     writes IN's H x W x C 8-bit samples (C 1 or 3) as SOF3 with the
 *     predictor (1-7) and point transform PT, a restart every ROWS sample
 *     rows (0: none); 3 components as libjpeg's RGB (ids 'R','G','B' and an
 *     Adobe marker).
 *   jpeg_process_writer twelve IN.raw OUT.jpg W H C LOSSLESS
 *     writes IN's 16-bit little-endian samples (< 4096) as a 12-bit file:
 *     SOF1 (LOSSLESS 0) or SOF3 (LOSSLESS 1, predictor 1).
 *   jpeg_process_writer layout IN.raw OUT.jpg W H C SPACE ADOBE FACTORS
 *                              QUALITY PROGRESSIVE ARITH PREDICTOR ROWS
 *     writes IN's H x W x C 8-bit samples (C 1-4; 3 read as RGB, 4 as
 *     CMYK) in the colour space SPACE (grey, ycc, rgb, cmyk, ycck or
 *     unknown), with an Adobe marker where libjpeg writes one (ADOBE 1) or
 *     none (ADOBE 0), per-component sampling factors FACTORS ("hv,hv,...",
 *     e.g. "41,11,11" for 4:1:1), at QUALITY; PROGRESSIVE and ARITH 0/1;
 *     PREDICTOR 1-7 makes a lossless (SOF3) file, 0 a DCT one; a restart
 *     every ROWS MCU rows (0: none).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* libjpeg-turbo 3's entry points, absent from older headers */
extern void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                                 int point_transform);
extern JDIMENSION jpeg12_write_scanlines(j_compress_ptr cinfo, short **scanlines,
                                         JDIMENSION num_lines);

static unsigned char *read_all(const char *path, long *size) {
  FILE *f = fopen(path, "rb");
  if (!f) { perror(path); exit(1); }
  fseek(f, 0, SEEK_END);
  *size = ftell(f);
  fseek(f, 0, SEEK_SET);
  unsigned char *buf = malloc(*size);
  if (fread(buf, 1, *size, f) != (size_t)*size) { perror(path); exit(1); }
  fclose(f);
  return buf;
}

static int arith(int argc, char **argv) {
  if (argc != 9) return 2;
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jerr_src, jerr_dst;
  src.err = jpeg_std_error(&jerr_src);
  jpeg_create_decompress(&src);
  dst.err = jpeg_std_error(&jerr_dst);
  jpeg_create_compress(&dst);
  FILE *in = fopen(argv[2], "rb"), *out = fopen(argv[3], "wb");
  if (!in || !out) { perror("open"); return 1; }
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  dst.optimize_coding = FALSE;
  if (atoi(argv[4])) jpeg_simple_progression(&dst);
  int restart = atoi(argv[5]);
  dst.restart_interval = restart < 0 ? src.restart_interval : (unsigned)restart;
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    dst.arith_dc_L[i] = (UINT8)atoi(argv[6]);
    dst.arith_dc_U[i] = (UINT8)atoi(argv[7]);
    dst.arith_ac_K[i] = (UINT8)atoi(argv[8]);
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}

static void start(struct jpeg_compress_struct *c, struct jpeg_error_mgr *jerr, FILE *out,
                  int w, int h, int comps) {
  c->err = jpeg_std_error(jerr);
  jpeg_create_compress(c);
  jpeg_stdio_dest(c, out);
  c->image_width = w;
  c->image_height = h;
  c->input_components = comps;
  c->in_color_space = comps == 3 ? JCS_RGB : JCS_GRAYSCALE;
}

static int lossless(int argc, char **argv) {
  if (argc != 10) return 2;
  long size;
  unsigned char *pix = read_all(argv[2], &size);
  int w = atoi(argv[4]), h = atoi(argv[5]), comps = atoi(argv[6]);
  if (size != (long)w * h * comps) { fprintf(stderr, "raw size\n"); return 1; }
  FILE *out = fopen(argv[3], "wb");
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  start(&c, &jerr, out, w, h, comps);
  jpeg_set_defaults(&c);
  if (comps == 3) jpeg_set_colorspace(&c, JCS_RGB); /* ids 'R','G','B', an Adobe marker */
  jpeg_enable_lossless(&c, atoi(argv[7]), atoi(argv[8]));
  c.restart_in_rows = atoi(argv[9]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pix + (long)c.next_scanline * w * comps;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pix);
  return 0;
}

static int twelve(int argc, char **argv) {
  if (argc != 8) return 2;
  long size;
  short *pix = (short *)read_all(argv[2], &size);
  int w = atoi(argv[4]), h = atoi(argv[5]), comps = atoi(argv[6]);
  if (size != 2L * w * h * comps) { fprintf(stderr, "raw size\n"); return 1; }
  FILE *out = fopen(argv[3], "wb");
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  start(&c, &jerr, out, w, h, comps);
  c.data_precision = 12;
  jpeg_set_defaults(&c);
  if (comps == 3) jpeg_set_colorspace(&c, JCS_RGB);
  if (atoi(argv[7])) jpeg_enable_lossless(&c, 1, 0);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    short *row = pix + (long)c.next_scanline * w * comps;
    jpeg12_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pix);
  return 0;
}

static int layout(int argc, char **argv) {
  if (argc != 15) return 2;
  long size;
  unsigned char *pix = read_all(argv[2], &size);
  int w = atoi(argv[4]), h = atoi(argv[5]), comps = atoi(argv[6]);
  if (size != (long)w * h * comps) { fprintf(stderr, "raw size\n"); return 1; }
  const char *space = argv[7];
  FILE *out = fopen(argv[3], "wb");
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  start(&c, &jerr, out, w, h, comps);
  c.in_color_space = comps == 1 ? JCS_GRAYSCALE : comps == 3 ? JCS_RGB
                     : comps == 4 ? JCS_CMYK : JCS_UNKNOWN;
  jpeg_set_defaults(&c);
  J_COLOR_SPACE target = !strcmp(space, "grey") ? JCS_GRAYSCALE : !strcmp(space, "ycc") ? JCS_YCbCr
                         : !strcmp(space, "rgb") ? JCS_RGB : !strcmp(space, "cmyk") ? JCS_CMYK
                         : !strcmp(space, "ycck") ? JCS_YCCK : JCS_UNKNOWN;
  jpeg_set_colorspace(&c, target);
  if (!atoi(argv[8])) c.write_Adobe_marker = FALSE;
  const char *f = argv[9];
  for (int i = 0; i < c.num_components; i++) {
    if (f[0] < '1' || f[0] > '4' || f[1] < '1' || f[1] > '4') { fprintf(stderr, "factors\n"); return 1; }
    c.comp_info[i].h_samp_factor = f[0] - '0';
    c.comp_info[i].v_samp_factor = f[1] - '0';
    f += 2;
    if (*f == ',') f++;
  }
  jpeg_set_quality(&c, atoi(argv[10]), TRUE);
  if (atoi(argv[11])) jpeg_simple_progression(&c);
  c.arith_code = atoi(argv[12]) ? TRUE : FALSE;
  if (atoi(argv[13])) jpeg_enable_lossless(&c, atoi(argv[13]), 0);
  c.restart_in_rows = atoi(argv[14]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pix + (long)c.next_scanline * w * comps;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pix);
  return 0;
}

int main(int argc, char **argv) {
  int rc = 2;
  if (argc > 1 && strcmp(argv[1], "arith") == 0) rc = arith(argc, argv);
  else if (argc > 1 && strcmp(argv[1], "lossless") == 0) rc = lossless(argc, argv);
  else if (argc > 1 && strcmp(argv[1], "twelve") == 0) rc = twelve(argc, argv);
  else if (argc > 1 && strcmp(argv[1], "layout") == 0) rc = layout(argc, argv);
  if (rc == 2) fprintf(stderr, "usage: see the comment at the top of the source\n");
  return rc;
}
