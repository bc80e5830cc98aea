"""Paper Section IV application (the port of
``examples/image_reconstruction.py``): reconstruct an image through
fixed-point FFT -> IFFT with approximate adders; report PSNR/SSIM per
adder and save the images (paper Fig 5).  On the card each
reconstruction is four ``fft_axis`` launches.

    PYTHONPATH=src python -m repro_torch.examples.image_reconstruction
    PYTHONPATH=src python -m repro_torch.examples.image_reconstruction \\
        --size 64 --device cpu --out /tmp/imgs

Images go to ``build/images_torch/`` by default (PNG, where Pillow is
installed).
"""

from __future__ import annotations

import argparse
import os

from repro_torch.core.specs import TABLE1_KINDS, paper_spec
from repro_torch.examples._cli import add_device_args, backend_and_device
from repro_torch.image.pipeline import reconstruct, synthetic_image
from repro_torch.image.quality import psnr, quality_band, ssim

OUT = os.path.join("build", "images_torch")


def _save(img, path: str) -> None:
    try:
        from PIL import Image
    except ImportError:
        return
    Image.fromarray(img).save(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    backend, dev = backend_and_device(args)

    img = synthetic_image(args.size)
    os.makedirs(args.out, exist_ok=True)
    _save(img, os.path.join(args.out, "source.png"))

    print(f"{'adder':10s} {'PSNR':>8s} {'SSIM':>7s} {'band':>12s}")
    scores = {}
    for kind in TABLE1_KINDS:
        rec = reconstruct(img, paper_spec(kind), backend=backend,
                          device=dev).cpu().numpy()
        p, s = psnr(img, rec), ssim(img, rec)
        scores[kind] = (p, s)
        print(f"{kind:10s} {p:8.2f} {s:7.3f} {quality_band(s):>12s}")
        _save(rec, os.path.join(args.out, f"recon_{kind}.png"))
    print(f"\nimages written to {args.out}/")
    return {"scores": scores}


if __name__ == "__main__":
    main()
