"""Command-line argument parsers (the port's copy of the JAX package's).

The CLI contract is kept identical to the reference (utils/parsers.py:5-31
and the inline parsers in assessment_change.py:64-80,
assessment_semantics.py:155-171, qualitative_comparison.py:170-186):
``-c/--config-file -p/--project -o/--output-dir -d/--dataset-dir``
plus a trailing REMAINDER ``opts`` list of config overrides. Each parser of
an entry point that runs a model (training, the assessments, the comparison
figure) adds ``--device`` before the overrides: the port's entry points run
on the card unless asked for the CPU. ``preprocess`` and ``metadata`` run no
model and take no ``--device``.
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
    _device_and_opts(parser)
    return parser


def _device_and_opts(parser: argparse.ArgumentParser) -> None:
    """``--device`` (before the overrides), then the REMAINDER ``opts``."""
    parser.add_argument("--device", dest='device', default=None,
                        help="torch device to run the model on (default: "
                             "the CUDA card; 'cpu' runs on the CPU)")
    _opts(parser)


def _opts(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "opts",
        help="Modify config options using the command-line",
        default=None,
        nargs=argparse.REMAINDER,
    )


def preprocess_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Experiment Args")
    parser.add_argument('-d', "--dataset", dest='dataset', required=True,
                        help="path to dataset")
    _opts(parser)
    return parser


def assessment_argument_parser() -> argparse.ArgumentParser:
    """Shared by assessment_change / assessment_semantics (their inline
    parsers are identical apart from the default run type, which callers set
    via ``set_defaults``)."""
    parser = argparse.ArgumentParser(description="Experiment Args")
    parser.add_argument('-c', "--config-file", dest='config_file', required=True,
                        help="path to config file")
    parser.add_argument('-o', "--output-dir", dest='output_dir', required=True,
                        help="path to output directory")
    parser.add_argument('-d', "--dataset-dir", dest='dataset_dir', default="",
                        required=True, help="path to output directory")
    parser.add_argument('-r', "--run-type", dest='run_type', default="test",
                        required=False, help="run type")
    _device_and_opts(parser)
    return parser


def comparison_argument_parser() -> argparse.ArgumentParser:
    """qualitative_comparison takes ``-c`` as a list of config names
    (reference: qualitative_comparison.py:174)."""
    parser = argparse.ArgumentParser(description="Experiment Args")
    parser.add_argument('-c', '--config-files', nargs='+', required=True,
                        help="path to config file")
    parser.add_argument('-o', "--output-dir", dest='output_dir', required=True,
                        help="path to output directory")
    parser.add_argument('-d', "--dataset-dir", dest='dataset_dir', default="",
                        required=True, help="path to output directory")
    parser.add_argument('-r', "--run-type", dest='run_type', default="test",
                        required=False, help="run type")
    _device_and_opts(parser)
    return parser


def metadata_argument_parser() -> argparse.ArgumentParser:
    """upload_study_area contract (reference upload_study_area.py:47-61):
    ``-s/--spacenet7-dir`` (required), ``-c/--config-file`` (default 'base'),
    trailing REMAINDER ``opts``."""
    parser = argparse.ArgumentParser(description="Experiment Args")
    parser.add_argument('-s', "--spacenet7-dir", dest='spacenet7_dir',
                        required=True, help="path to SpaceNet7 dataset")
    parser.add_argument('-c', "--config-file", dest='config_file',
                        required=False, default="base",
                        help="path to config file")
    _opts(parser)
    return parser
