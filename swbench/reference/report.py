"""The report of one input file, as the upstream project writes it
(``InOutOps.GetOutputStr``), without its Execution Time line: the lines
the system's report must hold, worked out from the reference's answers."""

from __future__ import annotations

from typing import List, Sequence, Tuple

Site = Tuple[int, Tuple[str, str]]


def report_lines(reads: Sequence[str], num_refs: int, max_score: int,
                 winners: Sequence[Tuple[str, str, Sequence[Site]]]) -> List[str]:
    """Lines of the report after its Execution Time line.

    ``winners``: (metadata, sequence, sites) of each winning reference,
    in the report's order (by metadata).
    """
    lines = ["", f"# Reference Sequences = {num_refs}", f"# Reads = {len(reads)}", "", "Input:"]
    lines.extend(reads)
    lines.append("")
    lines.append(f"Maximum alignment score = {max_score}")
    for metadata, sequence, sites in winners:
        lines.extend(["Reference:", metadata, sequence, ""])
        for index, (aligned_ref, aligned_read) in sites:
            lines.extend([f"\tIndex = {index}", f"\t{aligned_ref}", f"\t{aligned_read}", ""])
    lines.append("")  # the text ends with a newline
    return lines


def stripped(text: str) -> List[str]:
    """A report's lines without its Execution Time line."""
    lines = text.split("\n")
    return lines[1:] if lines[0].startswith("Execution Time") else lines


def lines_differing(expected: List[str], got: List[str]) -> int:
    """Lines that differ at the same position, plus the difference in count."""
    return sum(a != b for a, b in zip(expected, got)) + abs(len(expected) - len(got))
