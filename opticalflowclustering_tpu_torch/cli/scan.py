"""Document scanner CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/scan.py`, with the flags of
`DocumentScanner/scan.py`):

  -i doc.jpg [-o out_prefix] [--device cuda|cpu]

Writes <prefix>_warped.png and <prefix>_binarized.png.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-o", "--out", default="scanned")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; it raises where there is no CUDA "
                    "device rather than running on the CPU)")
    args = ap.parse_args(argv)

    import cv2

    from opticalflowclustering_tpu_torch.extras.document_scanner import scan_document
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    warped, binarized = scan_document(cv2.imread(args.image), device=dev)
    if warped is None:
        print("no 4-point document contour found")
        return
    cv2.imwrite(args.out + "_warped.png", warped)
    cv2.imwrite(args.out + "_binarized.png", binarized)
    print(f"wrote {args.out}_warped.png {args.out}_binarized.png ({warped.shape[1]}x{warped.shape[0]})")


if __name__ == "__main__":
    main()
