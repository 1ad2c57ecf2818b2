/* Rewrites a JPEG's quantized coefficients (no decode, no loss), as
 * jpegtran does: arithmetic coding, a progressive scan script and a
 * restart interval, each optional; or encodes raw CMYK samples as YCCK.
 *
 *   cc -O2 transcode.c -ljpeg -o transcode
 *   transcode in.jpg out.jpg [arith] [prog] [rst=N] [dac]
 *   transcode --ycck W H in.cmyk out.jpg
 *
 * "dac" sets non-default arithmetic conditioning (DC L=1 U=4, AC K=2).
 * Needs a libjpeg built with C_ARITH_CODING_SUPPORTED. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

static int ycck(int w, int h, const char *in, const char *out) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  FILE *fi = fopen(in, "rb"), *fo = fopen(out, "wb");
  unsigned char *buf = malloc((size_t)w * h * 4);
  if (!fi || !fo || fread(buf, 4, (size_t)w * h, fi) != (size_t)w * h)
    return 1;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, fo);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 4;
  c.in_color_space = JCS_CMYK;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, 90, TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = buf + (size_t)c.next_scanline * w * 4;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(fo);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 6 && !strcmp(argv[1], "--ycck"))
    return ycck(atoi(argv[2]), atoi(argv[3]), argv[4], argv[5]);
  if (argc < 3) return 2;
  struct jpeg_decompress_struct s;
  struct jpeg_compress_struct d;
  struct jpeg_error_mgr es, ed;
  FILE *fi = fopen(argv[1], "rb"), *fo = fopen(argv[2], "wb");
  if (!fi || !fo) return 1;
  s.err = jpeg_std_error(&es);
  d.err = jpeg_std_error(&ed);
  jpeg_create_decompress(&s);
  jpeg_create_compress(&d);
  jpeg_stdio_src(&s, fi);
  jpeg_read_header(&s, TRUE);
  jvirt_barray_ptr *coef = jpeg_read_coefficients(&s);
  jpeg_copy_critical_parameters(&s, &d);
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "arith")) d.arith_code = TRUE;
    else if (!strcmp(argv[i], "prog")) jpeg_simple_progression(&d);
    else if (!strncmp(argv[i], "rst=", 4)) d.restart_interval = atoi(argv[i] + 4);
    else if (!strcmp(argv[i], "dac")) {
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        d.arith_dc_L[t] = 1;
        d.arith_dc_U[t] = 4;
        d.arith_ac_K[t] = 2;
      }
    } else return 2;
  }
  d.optimize_coding = !d.arith_code;
  jpeg_stdio_dest(&d, fo);
  jpeg_write_coefficients(&d, coef);
  jpeg_finish_compress(&d);
  jpeg_finish_decompress(&s);
  jpeg_destroy_compress(&d);
  jpeg_destroy_decompress(&s);
  fclose(fo);
  fclose(fi);
  return 0;
}
