"""Convert a directory of images to a raw-pixel TFRecord file (the port's
copy of tools/create_record.py, after the reference's
python/lib/utils/create_record.py): each image, in file-name order, resized
to HxW RGB and written as raw uint8 HWC bytes, the single ``image`` feature
of one Example.  Unreadable files are skipped with a line saying so.

    python -m wide_deep_tpu_torch.tools.create_record --input_dir DIR \
        --output F.tfrecords [--height 224] [--width 224]

Needs PIL (Pillow) to read the images; the records it writes are read back
without it (features/tfrecord.py, features/image.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    """-> the number of records written."""
    p = argparse.ArgumentParser(description="images -> TFRecord")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--width", type=int, default=224)
    args = p.parse_args(argv)

    from PIL import Image

    from wide_deep_tpu_torch.features.tfrecord import (serialize_example,
                                                       write_records)

    def payloads():
        for name in sorted(os.listdir(args.input_dir)):
            path = os.path.join(args.input_dir, name)
            try:
                img = Image.open(path).convert("RGB")
            except OSError:
                print(f"skipping unreadable {name}")
                continue
            img = img.resize((args.width, args.height))
            yield serialize_example({"image": [img.tobytes()]})

    n = write_records(args.output, payloads())
    print(f"wrote {n} records to {args.output}")
    return n


if __name__ == "__main__":
    main()
