"""The judges that ``reference/check.py`` finds by the names a workload
lists, and the reduction they share."""


def widest(vals):
    """The largest of the numbers that were read, None where none was."""
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None
