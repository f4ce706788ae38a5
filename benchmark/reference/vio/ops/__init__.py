"""Plain versions of the port's kernel wrappers: a frozen copy of their
`_ref` functions (isvins_tpu_torch/ops), each name bound to its plain
version so that the copied solver runs no kernel."""


def seq_rows(n: int, per_seq, name: str) -> int:
    """Rows per sequence when `n` rows are S equal runs laid end to end."""
    S = per_seq.shape[0] if per_seq.dim() == 2 else 1
    if S < 1 or n % S:
        raise ValueError(f"{name}: {n} rows do not split into {S} sequences")
    return max(n // S, 1)
