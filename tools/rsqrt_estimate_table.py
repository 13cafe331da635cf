"""Print the x86 ``rsqrtss`` estimate table that ``repro_torch.xla_f32``
uses to emulate XLA:CPU's float32 ``rsqrt``.

XLA:CPU lowers ``rsqrt`` to the hardware estimate (``vrsqrtps``) and two
Newton-Raphson steps.  The estimate has a 12-bit mantissa that depends
only on the parity of the input's exponent and the top 10 bits of its
mantissa, so 2 x 1024 entries describe it.  This script compiles a
small probe with ``g++``, runs it on the host CPU and prints the table
as ``xla_f32._RSQRT_EST`` spells it (three hex digits an entry, even
exponents first).  Run it on the host whose reference results the port
must match:

    python tools/rsqrt_estimate_table.py
"""
from __future__ import annotations

import pathlib
import subprocess
import tempfile

PROBE = r"""
#include <immintrin.h>
#include <cstdint>
#include <cstdio>
#include <cstring>
int main() {
  for (uint32_t ex = 126; ex <= 127; ex++)
    for (uint32_t t = 0; t < 1024; t++) {
      uint32_t b = (ex << 23) | (t << 13);
      float f, a;
      memcpy(&f, &b, 4);
      a = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set1_ps(f)));
      uint32_t u;
      memcpy(&u, &a, 4);
      printf("%03x", (u >> 11) & 0xfff);
    }
  return 0;
}
"""


def table() -> str:
    """The 2048 entries as one hex string, three digits an entry."""
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "probe.cc"
        exe = pathlib.Path(tmp) / "probe"
        src.write_text(PROBE)
        subprocess.run(["g++", "-O1", "-msse", "-o", str(exe), str(src)],
                       check=True)
        return subprocess.run([str(exe)], check=True, capture_output=True,
                              text=True).stdout.strip()


def main() -> None:
    hexes = table()
    print("_RSQRT_EST = (")
    for i in range(0, len(hexes), 72):
        print(f'    "{hexes[i:i + 72]}"')
    print(")")


if __name__ == "__main__":
    main()
