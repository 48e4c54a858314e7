"""Convert a msgpack checkpoint into the reference's ``.h5`` artifact (port
of ``scripts/export_reference_h5.py``).

The inverse of ``keras_nerf_tpu_torch.import_reference_h5``: writes
``model_config.json`` + ``coarse.h5`` + ``fine.h5``
(`keras_nerf/model/nerf/nerf.py:45-76`, legacy Keras-2 layout), so a model
trained by the port loads back into the TF implementation::

    python -m keras_nerf_tpu_torch.export_reference_h5 \\
        --model_dir model/quality128 --output_dir /path/to/ref_artifact

A host-side format conversion: it needs no card, and ``h5py``.
"""

import argparse
import logging

from keras_nerf_tpu_torch.utils.export_h5 import export_reference_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", required=True,
                        help="the msgpack checkpoint dir "
                             "(model_config.json + *.msgpack)")
    parser.add_argument("--output_dir", default=None,
                        help="where to write the reference artifact "
                             "(default: alongside the msgpack files)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    config = export_reference_model(args.model_dir, args.output_dir)
    out = args.output_dir or args.model_dir
    logging.info("exported %s -> reference artifact %s (%s)",
                 args.model_dir, out, config.to_model_config())


if __name__ == "__main__":
    main()
