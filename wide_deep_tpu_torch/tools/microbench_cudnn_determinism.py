"""What deterministic cuDNN costs the CNN arm: its forward + backward with
cuDNN's deterministic algorithms (the port's setting,
``models/deep.set_parity_precision``) and without.

    python -m wide_deep_tpu_torch.tools.microbench_cudnn_determinism \\
        [--models vgg16,resnet] [--device cpu]

For each model (VGG16 and ImageNet ResNet-50 v2 at 224 x 224 x 3 by
default), at batch 64 (chip_smoke phase 10's), the arm's params come from a
seeded generator and the images are random 0-255 pixels.  The forward +
backward (``testing.cnn_forward_backward``: logits, new BN state, every
gradient) is timed in turns deterministic / free / free / deterministic,
each turn the median of 5 calls by CUDA events after warm-up; cuDNN's
benchmark stays off and TF32 stays off.  Prints the devices line and one line a model: the two
medians of each setting and the relative cost.  Deterministic calls are
also checked to give the same bits twice (a mismatch exits non-zero).  With
``--device cpu`` the flag changes nothing and the times are the host's.
"""

from __future__ import annotations

import numpy as np
import torch

from wide_deep_tpu_torch import testing
from wide_deep_tpu_torch.models.cnn import CnnSpec, init_cnn_params
from wide_deep_tpu_torch.models.deep import set_parity_precision
from wide_deep_tpu_torch.tools import devices_line, median_ms, parse, parser

BATCH = 64
ITERS = 5


def same_bits(a, b) -> bool:
    la, sa, ga = a
    lb, sb, gb = b
    pairs = [(la, lb)] + [(ga[p], gb[p]) for p in ga] + [
        (sa[k][s], sb[k][s]) for k in sa for s in sa[k]]
    return all(torch.equal(x, y) for x, y in pairs)


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--models", default="vgg16,resnet")
    args, device = parse(p, argv)
    set_parity_precision()
    print(devices_line(device), flush=True)
    for model in args.models.split(","):
        spec = CnnSpec(model=model, resnet_size=50)
        gen = torch.Generator(device=device).manual_seed(0)
        rng = np.random.default_rng(0)
        images = torch.from_numpy(
            (rng.random((BATCH,) + spec.image_shape) * 255)
            .astype(np.float32)).to(device)
        params, state = init_cnn_params(gen, spec, 1, images[:1], device)
        cot = torch.ones((BATCH, 1), device=device)

        def call():
            return testing.cnn_forward_backward(spec, params, state, images,
                                                cot)
        times = {True: [], False: []}
        try:
            for det in (True, False, False, True):
                torch.backends.cudnn.deterministic = det
                if det and not same_bits(call(), call()):
                    raise SystemExit(f"{model}: deterministic cuDNN gave "
                                     f"other bits on a second call")
                times[det].append(median_ms(call, ITERS, device))
        finally:
            set_parity_precision()
        a, b = float(np.median(times[True])), float(np.median(times[False]))
        print(f"{model} at batch {BATCH}: forward + backward "
              f"deterministic {' / '.join(f'{t:.2f}' for t in times[True])}"
              f" ms, free {' / '.join(f'{t:.2f}' for t in times[False])} "
              f"ms ({100 * (a - b) / b:+.1f}%)", flush=True)
        del params, state, images
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
