"""Pack an image folder or list into RecordIO.

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list [--recursive]
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--resize 256]

The counterpart of ``tools/im2rec.py`` (the reference's
``tools/im2rec.py``): ``--list`` writes ``PREFIX.lst`` (``index\\tlabel...
\\tpath`` lines, shuffled with ``random.seed(100)`` unless ``--shuffle`` is
false, a folder a label with ``--recursive``); without it the images of
``PREFIX.lst`` are encoded with PIL (or copied with ``--pass-through``)
into ``PREFIX.rec`` with its ``PREFIX.idx``, the same bytes as the JAX
tool's.  The reference's native ``im2rec.cc`` packer is not ported
(ROADMAP Queue A item 3).
"""
from __future__ import annotations

import argparse
import os
import random

from .. import recordio

__all__ = ["list_image", "write_list", "read_list", "image_encode", "main"]


def list_image(root, recursive, exts):
    """``(index, relative path, label)`` of each image under ``root``."""
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
        for item in image_list:
            line = "%d\t" % item[0]
            for j in item[2:]:
                line += "%f\t" % j
            line += "%s\n" % item[1]
            fout.write(line)


def read_list(path_in):
    """``[index, path, label...]`` of each well-formed line."""
    with open(path_in) as fin:
        while True:
            line = fin.readline()
            if not line:
                break
            line = [i.strip() for i in line.strip().split("\t")]
            if len(line) < 3:
                continue
            try:
                item = [int(line[0])] + [line[-1]] + \
                    [float(i) for i in line[1:-1]]
            except ValueError:
                continue
            yield item


def image_encode(args, item):
    """One record of the image ``item``: its header and the image as
    stored (``pass_through``) or decoded, shorter edge resized down to
    ``resize``, and encoded in ``encoding``."""
    import io as _pyio

    import numpy as np
    from PIL import Image

    fullpath = os.path.join(args.root, item[1])
    header = recordio.IRHeader(0, item[2] if len(item) == 3 else
                               np.array(item[2:], dtype="float32"),
                               item[0], 0)
    if args.pass_through:
        with open(fullpath, "rb") as fin:
            img = fin.read()
        return recordio.pack(header, img)
    im = Image.open(fullpath).convert("RGB")
    if args.resize:
        w, h = im.size
        if min(w, h) > args.resize:
            if w > h:
                im = im.resize((int(w * args.resize / h), args.resize))
            else:
                im = im.resize((args.resize, int(h * args.resize / w)))
    buf = _pyio.BytesIO()
    fmt = "JPEG" if args.encoding in (".jpg", ".jpeg") else "PNG"
    kwargs = {"quality": args.quality} if fmt == "JPEG" else {}
    im.save(buf, format=fmt, **kwargs)
    return recordio.pack(header, buf.getvalue())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create an image list / RecordIO database",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("prefix", help="prefix of input/output lst and "
                        "rec files")
    parser.add_argument("root", help="path to folder containing images")
    parser.add_argument("--list", action="store_true",
                        help="make a list file first")
    parser.add_argument("--exts", nargs="+",
                        default=[".jpeg", ".jpg", ".png"])
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--shuffle", type=bool, default=True)
    parser.add_argument("--pass-through", action="store_true",
                        help="skip transformation and save image as is")
    parser.add_argument("--resize", type=int, default=0,
                        help="resize the shorter edge to this size")
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--encoding", type=str, default=".jpg",
                        choices=[".jpg", ".png"])
    args = parser.parse_args(argv)

    if args.list:
        image_list = list(list_image(args.root, args.recursive,
                                     set(args.exts)))
        if args.shuffle:
            random.seed(100)
            random.shuffle(image_list)
        write_list(args.prefix + ".lst", image_list)
        return

    image_list = list(read_list(args.prefix + ".lst"))
    record = recordio.MXIndexedRecordIO(args.prefix + ".idx",
                                        args.prefix + ".rec", "w")
    for i, item in enumerate(image_list):
        record.write_idx(item[0], image_encode(args, item))
        if i % 1000 == 0:
            print("processed", i)
    record.close()


if __name__ == "__main__":
    main()
