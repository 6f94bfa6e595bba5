"""Surface-projection CLI, flag-compatible with the reference
(``surface_projection.py:329-423``): -i/-o/-f/-n/-m/-r/-c/--method/--fixed/--file/
-b/--manifold/--only-position/--airyscan/--min-z/--max-z/--separate-files.

Run: ``python -m tissue_image_processing_tpu_torch.projection.cli -i DIR -n POS -m MOVIES``
(on the card). Inputs are .tif/.npy/.czi movie stores.

Port of ``tissue_image_processing_tpu/projection/cli.py`` with the same flags;
``main(argv, device=None, metrics=None)`` takes the device (``"cpu"`` for the
plain PyTorch route) and an optional ``StageMetrics`` as Python arguments,
not flags."""

from __future__ import annotations

import argparse
import os
from ast import literal_eval
from glob import glob

from tissue_image_processing_tpu_torch.projection.driver import (
    large_image_projection, movie_surface_projection)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tip-project", description=__doc__)
    p.add_argument("-i", "--input", default="", help="input directory with movies m1, m2, ...")
    p.add_argument("-o", "--output", default="", help="output directory")
    p.add_argument("-f", "--position-final-movie", dest="position_final_movie", default="")
    p.add_argument("-n", "--position-number", dest="position_number", type=int, default=1)
    p.add_argument("-m", "--movie-number", dest="movie_number", type=int, default=1)
    p.add_argument("-r", "--reference_channel", dest="reference_channel", type=int, default=1)
    p.add_argument("-c", "--chunk-size", dest="chunk_size", type=int, default=0)
    p.add_argument("--method", default="max_averages")
    p.add_argument("--fixed", dest="fixed_sample", action="store_true", default=False)
    p.add_argument("--file", dest="file_name", default=None)
    p.add_argument("-b", "--bin-size", dest="bin_size", type=int, default=1)
    p.add_argument("--manifold", dest="build_manifold", action="store_true", default=False)
    p.add_argument("--only-position", dest="only_position", type=int, default=0)
    p.add_argument("--airyscan", action="store_true", default=False)
    p.add_argument("--min-z", dest="zmin", type=int, default=0)
    p.add_argument("--max-z", dest="zmax", type=int, default=0)
    p.add_argument("--separate-files", dest="separate_files", action="store_true",
                   default=False)
    p.add_argument("--ext", default="tif", help="movie container extension (tif/npy)")
    return p


def main(argv=None, device=None, metrics=None) -> int:
    options = build_parser().parse_args(argv)
    input_dir = options.input or os.getcwd()
    output_dir = options.output or input_dir
    if options.fixed_sample:
        large_image_projection(
            input_dir, output_dir, options.file_name,
            reference_channel=options.reference_channel, chunk_size=options.chunk_size,
            bin_size=options.bin_size, method=options.method,
            build_manifold=options.build_manifold, min_z=options.zmin,
            max_z=options.zmax, airyscan=options.airyscan, device=device)
    elif options.separate_files:
        files = sorted(glob(os.path.join(input_dir, f"*.{options.ext}")))
        for file in files:
            movie_surface_projection(
                [file], options.reference_channel, (1,), options.position_number,
                output_dir, method=options.method, bin_size=options.bin_size,
                build_manifold=options.build_manifold,
                only_position=options.only_position, zmin=options.zmin,
                zmax=options.zmax, airyscan=options.airyscan,
                output_name=os.path.basename(file), metrics=metrics,
                device=device)
    else:
        if options.position_final_movie:
            position_final_movie = list(literal_eval(options.position_final_movie))
        else:
            position_final_movie = [options.movie_number] * options.position_number
        files = [os.path.join(input_dir, "m%d.%s" % (i + 1, options.ext))
                 for i in range(options.movie_number)]
        movie_surface_projection(
            files, options.reference_channel, position_final_movie,
            options.position_number, output_dir, method=options.method,
            bin_size=options.bin_size, build_manifold=options.build_manifold,
            only_position=options.only_position, zmin=options.zmin, zmax=options.zmax,
            airyscan=options.airyscan, metrics=metrics, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
