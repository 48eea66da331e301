"""Time the f32 flash kernels of the package under ROOT at the main shapes and
keep their outputs, so that two trees can be run by turns in one call and held
bit-equal: PYTHONPATH=ROOT python3 logs/f32_turns.py TAG  (then: --compare A B)."""
import json
import subprocess
import sys

import torch

if sys.argv[1] == "--compare":
    a, b = (torch.load(f".chipwork/turns_{t}.pt") for t in sys.argv[2:4])
    print(json.dumps({"bit_equal": {k: torch.equal(a[k], b[k]) for k in a}}), flush=True)
    sys.exit(0)

from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
tag = sys.argv[1]


def time_ms(fn, iters=30):
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(iters * 1e6))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


keep = {}
res = {"tag": tag, "root": fa.__file__, "card": subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
    text=True).stdout.strip()}
for b, h, l in ((16, 12, 768), (8, 16, 768), (1, 12, 5999)):
    g = torch.Generator().manual_seed(l + b)
    q, k, v, dout = (torch.randn(b, h, l, 64, generator=g).cuda() for _ in range(4))
    q = q * 0.25
    lengths = torch.randint(l // 4, l + 1, (b,), generator=g)
    bias = torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).cuda()
    out, lse = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=3)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, dout, dropout_rate=0.1, seed=3)
    if l == 768 and b == 16:
        keep.update(out=out, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2])
    key = f"{b}x{h}x{l}"
    res[key] = {"fwd_ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias)),
                "fwd_drop_ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=3)),
                "bwd_drop_ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                                                       dropout_rate=0.1, seed=3))}
torch.save({k: t.cpu() for k, t in keep.items()}, f".chipwork/turns_{tag}.pt")
print(json.dumps(res), flush=True)
