from .reader import (FastqBatch, FastqReader, peek_first_record, read_tuples,
                     skip_to_record)
from .writer import FastqWriter, build_records, build_records_annotated
from .names import add_dir, make_file_name, make_file_names

__all__ = [
    "FastqReader",
    "FastqBatch",
    "read_tuples",
    "peek_first_record",
    "skip_to_record",
    "FastqWriter",
    "build_records",
    "build_records_annotated",
    "add_dir",
    "make_file_name",
    "make_file_names",
]
