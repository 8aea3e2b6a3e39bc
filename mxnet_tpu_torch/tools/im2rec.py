#!/usr/bin/env python
"""im2rec — pack an image directory/list into a RecordIO dataset.

Reference: ``tools/im2rec.py`` / ``tools/im2rec.cc`` (SURVEY.md §2.16):
makes a ``.lst`` (index\\tlabel\\tpath) from a directory tree, then encodes
images into ``.rec`` (+ ``.idx``) via multiprocess workers.

The port's copy of the reference package's ``tools/im2rec.py``.

Usage:
    python -m mxnet_tpu_torch.tools.im2rec prefix image_root --list
    python -m mxnet_tpu_torch.tools.im2rec prefix image_root
"""
from __future__ import annotations

import argparse
import os
import random


def list_image(root, recursive, exts):
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and (suffix in exts):
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and (suffix in exts):
                yield (i, os.path.relpath(fpath, root), 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, "w") as fout:
        for i, item in enumerate(image_list):
            line = "%d\t" % item[0]
            for j in item[2:]:
                line += "%f\t" % j
            line += "%s\n" % item[1]
            fout.write(line)


def read_list(path_in):
    with open(path_in) as fin:
        for line in fin:
            line = line.strip().split("\t")
            if len(line) < 3:
                continue
            yield (int(line[0]), line[-1], [float(x) for x in line[1:-1]])


def make_rec(args):
    import cv2
    from .. import recordio

    lst = args.prefix + ".lst"
    items = list(read_list(lst))
    rec = recordio.MXIndexedRecordIO(args.prefix + ".idx",
                                     args.prefix + ".rec", "w")
    for idx, path, labels in items:
        fullpath = os.path.join(args.root, path)
        img = cv2.imread(fullpath, args.color)
        if img is None:
            print("imread failed:", fullpath)
            continue
        if args.resize:
            h, w = img.shape[:2]
            if h > w:
                newsize = (args.resize, int(h * args.resize / w))
            else:
                newsize = (int(w * args.resize / h), args.resize)
            img = cv2.resize(img, newsize)
        label = labels[0] if len(labels) == 1 else labels
        flag = 0 if len(labels) == 1 else len(labels)
        header = recordio.IRHeader(flag, label, idx, 0)
        rec.write_idx(idx, recordio.pack_img(header, img,
                                             quality=args.quality,
                                             img_fmt=args.encoding))
    rec.close()
    print("wrote %s.rec (%d records)" % (args.prefix, len(items)))


def main():
    parser = argparse.ArgumentParser(description="Create an image RecordIO dataset")
    parser.add_argument("prefix", help="prefix of .lst/.rec files")
    parser.add_argument("root", help="image root directory")
    parser.add_argument("--list", action="store_true",
                        help="make a .lst file instead of .rec")
    parser.add_argument("--exts", nargs="+",
                        default=[".jpeg", ".jpg", ".png"])
    parser.add_argument("--recursive", action="store_true", default=True)
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--resize", type=int, default=0)
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--encoding", type=str, default=".jpg")
    parser.add_argument("--color", type=int, default=1)
    args = parser.parse_args()
    if args.list:
        images = list(list_image(args.root, args.recursive, args.exts))
        if args.shuffle:
            random.seed(100)
            random.shuffle(images)
        write_list(args.prefix + ".lst", images)
        print("wrote %s.lst (%d entries)" % (args.prefix, len(images)))
    else:
        if not os.path.isfile(args.prefix + ".lst"):
            images = list(list_image(args.root, args.recursive, args.exts))
            write_list(args.prefix + ".lst", images)
        make_rec(args)


if __name__ == "__main__":
    main()
