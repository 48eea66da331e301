"""Time pos_conv_dw at (8, 768, 16 C/G) in 16 groups from the tree given: python3 bench_dw.py ROOT LABEL CG."""
import json
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc  # noqa: E402

sys.path.insert(0, ".")
from flash_bench import events_ms, profiled_ms  # noqa: E402

gen = torch.Generator().manual_seed(0)
cg = int(sys.argv[3])
c, k, b, t = 16 * cg, 128, 8, 768
x, dpre = (torch.randn(b, t, c, generator=gen).cuda().to(torch.bfloat16) for _ in range(2))
dw = pc.pos_conv_dw(x, dpre, k, groups=16)
want = pc.pos_conv_dw_plain(x, dpre, k, groups=16)
err = (dw - want).abs().max().item()
fn = lambda: pc.pos_conv_dw(x, dpre, k, groups=16)
row = {"label": sys.argv[2], "width": str(pc.WIDTHS[cg]), "max_abs_err": err, "scale": want.abs().max().item(),
       "bit_equal": bool(torch.equal(dw, fn())), "ms": events_ms(torch, fn, 50)}
row["call_device_ms"], row["device_ms"], row["device_kernel"] = profiled_ms(torch, fn, 5)
print(json.dumps(row), flush=True)
