"""Input/output of the port: reads and reference parsing, directory
crawling and the result report."""

from sparksmithwaterman_tpu_torch.io.crawler import iter_files
from sparksmithwaterman_tpu_torch.io.fasta import decode_seq, encode_seq, get_reads, get_ref_seqs, is_metadata
from sparksmithwaterman_tpu_torch.io.report import build_report, format_matrices, write_str_to_file

__all__ = [
    "get_reads",
    "get_ref_seqs",
    "is_metadata",
    "encode_seq",
    "decode_seq",
    "iter_files",
    "build_report",
    "format_matrices",
    "write_str_to_file",
]
