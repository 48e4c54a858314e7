"""Convert a reference-trained checkpoint (``.h5``) into the msgpack
checkpoint both packages load (port of ``scripts/import_reference_h5.py``).

The reference's ``save_model`` writes ``model_config.json`` + ``coarse.h5``
+ ``fine.h5`` (`keras_nerf/model/nerf/nerf.py:45-64`)::

    python -m keras_nerf_tpu_torch.import_reference_h5 \\
        --model_dir /path/to/ref/lego --output_dir model/lego
    python -m keras_nerf_tpu_torch.inference --model_dirs model/lego ...

A host-side format conversion: it needs no card. Legacy Keras-2 ``.h5``
files (what the reference produces) need ``h5py``; Keras-3
``.weights.h5`` files also TensorFlow and the reference package.
"""

import argparse
import logging

from keras_nerf_tpu_torch.utils.import_h5 import import_reference_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", required=True,
                        help="reference artifact dir (model_config.json + "
                             "coarse.h5 + fine.h5)")
    parser.add_argument("--output_dir", default=None,
                        help="where to write the msgpack checkpoint "
                             "(default: alongside the .h5 files)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    config = import_reference_model(args.model_dir, args.output_dir)
    out = args.output_dir or args.model_dir
    logging.info("imported reference checkpoint %s -> %s (%s)",
                 args.model_dir, out, config.to_model_config())


if __name__ == "__main__":
    main()
