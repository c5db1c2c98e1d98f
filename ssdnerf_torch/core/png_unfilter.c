/* Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of one
 * image, byte by byte along each row, as the PNG specification defines
 * them.  Plain C with no headers, built by ssdnerf_torch/core/png.py on
 * first use and called through ctypes (which releases the GIL, so the
 * dataset's decode threads run it in parallel).
 *
 * src: h rows of (1 filter byte + rowbytes) bytes; dst: h * rowbytes bytes;
 * bpp: bytes per complete pixel (at least 1).  Returns 0, or 1 + the row
 * whose filter type is unknown. */
static unsigned char paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (unsigned char)a;
    return (unsigned char)(pb <= pc ? b : c);
}

int png_unfilter(const unsigned char *src, unsigned char *dst, int h,
                 int rowbytes, int bpp) {
    for (int y = 0; y < h; ++y) {
        const unsigned char *in = src + (long)y * (rowbytes + 1) + 1;
        unsigned char *out = dst + (long)y * rowbytes;
        const unsigned char *up = y ? out - rowbytes : 0;
        int i;
        switch (in[-1]) {
        case 0:
            for (i = 0; i < rowbytes; ++i) out[i] = in[i];
            break;
        case 1:
            for (i = 0; i < bpp && i < rowbytes; ++i) out[i] = in[i];
            for (; i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + out[i - bpp]);
            break;
        case 2:
            for (i = 0; i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (i = 0; i < bpp && i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + ((up ? up[i] : 0) >> 1));
            for (; i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + ((out[i - bpp]
                                                   + (up ? up[i] : 0)) >> 1));
            break;
        case 4:
            for (i = 0; i < bpp && i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + (up ? up[i] : 0));
            for (; i < rowbytes; ++i)
                out[i] = (unsigned char)(in[i] + (up ? paeth(out[i - bpp],
                    up[i], up[i - bpp]) : out[i - bpp]));
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
