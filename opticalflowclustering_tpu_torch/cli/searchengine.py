"""Image search CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/searchengine.py`, mirroring
`FirstImageSearchEngine/indexdataset.py` and `image-search-engine.py` /
`external-query.py`): index a directory of images as RGB-histogram features
(npz rather than cPickle), then rank the index against a query image by chi²
distance.

  index -d photos/ -i index.npz [--device cuda|cpu]
  search -i index.npz -q query.png [-k 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ixp = sub.add_parser("index")
    ixp.add_argument("-d", "--dataset", required=True)
    ixp.add_argument("-i", "--index", required=True)
    sp = sub.add_parser("search")
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-q", "--query", required=True)
    sp.add_argument("-k", type=int, default=10)
    for p in (ixp, sp):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; it raises where there is no CUDA "
                       "device rather than running on the CPU)")
    args = ap.parse_args(argv)

    import cv2

    from opticalflowclustering_tpu_torch.extras.search_engine import RGBHistogram, Searcher, index_images
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    if args.cmd == "index":
        names = sorted(n for n in os.listdir(args.dataset) if n.lower().endswith((".png", ".jpg", ".jpeg")))
        imgs, kept = [], []
        for n in names:
            im = cv2.imread(os.path.join(args.dataset, n))
            if im is not None:
                imgs.append(cv2.resize(im, (166, 100)))
                kept.append(n)
        feats = index_images(np.stack(imgs), device=dev)
        np.savez(args.index, names=np.array(kept), features=feats)
        print(f"indexed {len(kept)} images -> {args.index}")
    else:
        z = np.load(args.index, allow_pickle=False)
        index = {str(n): f for n, f in zip(z["names"], z["features"])}
        q = cv2.resize(cv2.imread(args.query), (166, 100))
        results = Searcher(index, device=dev).search(RGBHistogram(device=dev).describe(q))
        for dist, name in results[: args.k]:
            print(f"{dist:.4f}\t{name}")


if __name__ == "__main__":
    main()
