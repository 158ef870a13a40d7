"""Command-line argument parsers (the port's copy of the JAX package's).

The CLI contract is kept identical to the reference (utils/parsers.py:5-31
and the inline parsers in assessment_change.py:64-80,
assessment_semantics.py:155-171, qualitative_comparison.py:170-186):
``-c/--config-file -p/--project -o/--output-dir -d/--dataset-dir``
plus a trailing REMAINDER ``opts`` list of config overrides. The training
parser adds ``--device`` (before the overrides): the port's entry points run
on the card unless asked for the CPU.
"""

import argparse


def training_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Experiment Args")
    parser.add_argument('-c', "--config-file", dest='config_file', required=True,
                        help="path to config file")
    parser.add_argument('-p', "--project", dest='project', required=True,
                        help="w&b project")
    parser.add_argument('-o', "--output-dir", dest='output_dir', required=True,
                        help="path to output directory")
    parser.add_argument('-d', "--dataset-dir", dest='dataset_dir', default="",
                        required=True, help="path to output directory")
    parser.add_argument("--device", dest='device', default=None,
                        help="torch device to train on (default: the CUDA "
                             "card; 'cpu' runs on the CPU)")
    parser.add_argument(
        "opts",
        help="Modify config options using the command-line",
        default=None,
        nargs=argparse.REMAINDER,
    )
    return parser
