"""Time a checkout's SSD scan (kernel #8) on the values of phase 16's bf16
path rows, cast to f32: the kernel alone on f32 contiguous copies, and the
call with the casts a Mamba-2 mixer makes when it feeds the scan f32
(u.float(), B.float(), C.float() from bf16 u and row views of one bf16
(Bz, S, 2 N) tensor). For checkouts whose phase 16 has no bf16 rows.

    cd CHECKOUT && python3 /path/to/scripts/ssd_f32_copies.py

Uses the checkout's own chip_smoke.py (time_ms, ssd_work, ssd_inputs) and
kernels; needs a CUDA card.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402

PATH = (("zamba2_prefill", (4, 256, 112, 64, 64, 256)),
        ("zamba2_768", (1, 768, 112, 64, 64, 256)),
        ("zamba2_4096", (1, 4096, 112, 64, 64, 256)))


def main() -> None:
    card = c.card_line()
    gen = torch.Generator(device="cuda").manual_seed(16)
    for name, (bz, s, h, dh, n, chunk) in PATH:
        nbytes, _ = c.ssd_work(bz, s, h, dh, n, chunk)
        n_sets = max(1, min(24, int(120e6 // nbytes) + 1))
        sets = []
        for u, dt, a, b, cc in c.ssd_inputs(bz, s, h, dh, n, gen, n_sets):
            u = u.bfloat16()
            b, cc = torch.split(torch.cat([b, cc], -1).bfloat16(), n, dim=-1)
            sets.append((u, dt, a, b, cc))
        f32 = [(u.float(), dt, a, b.float().contiguous(),
                cc.float().contiguous()) for u, dt, a, b, cc in sets]

        def kern(*x, chunk=chunk):
            return ssd_scan_cuda(*x, chunk)

        def path(u, dt, a, b, cc, chunk=chunk):
            return ssd_scan_cuda(u.float(), dt, a, b.float(), cc.float(),
                                 chunk)

        k_ms = c.time_ms(kern, f32)
        p_ms = c.time_ms(path, sets)
        print(f"[parent] ssd_scan {name} bf16 values: kernel on f32 copies "
              f"{k_ms:.4f} ms; with the mixer's casts {p_ms:.4f} ms | {card}",
              flush=True)


if __name__ == "__main__":
    main()
