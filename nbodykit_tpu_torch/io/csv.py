"""CSVFile: partitioned reads of delimited text via pandas.

A copy of ``nbodykit_tpu/io/csv.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/csv.py:213`` (byte-range partitioned pandas
reads). Here partitioning is by row ranges with ``pandas.read_csv``
(skiprows/nrows); same contract, simpler bookkeeping.
"""

import numpy as np

from .base import FileType


class CSVFile(FileType):
    """Delimited text file of named numeric columns.

    Parameters
    ----------
    path : file path
    names : column names, in file order
    dtype : dtype per column: one dtype for all, or dict name -> dtype
    delim_whitespace : bool — whitespace-delimited (default) or use
        ``sep``
    usecols : restrict to a subset of names
    **config : forwarded to pandas.read_csv
    """

    def __init__(self, path, names, dtype='f8', usecols=None,
                 delim_whitespace=True, **config):
        import pandas as pd
        self.path = path
        # parse with the FULL name list (pandas aligns names to file
        # columns); usecols only selects what this file EXPOSES
        self._all_names = list(names)
        self._names = list(names)
        if usecols is not None:
            self._names = [n for n in self._all_names if n in usecols]
        if isinstance(dtype, dict):
            dt = [(n, dtype.get(n, 'f8')) for n in self._names]
        else:
            dt = [(n, dtype) for n in self._names]
        self.dtype = np.dtype(dt)
        self._config = dict(config)
        # the partitioned-read contract cannot honor these pandas
        # keywords (reference nbodykit/io/csv.py raises on its own
        # forbidden set: names would shift, rows would double-count)
        for bad_kw in ('index_col', 'header', 'skipfooter'):
            if bad_kw in self._config:
                raise ValueError(
                    "keyword %r is not supported by the partitioned "
                    "CSV reader" % bad_kw)
        # skiprows/nrows are partitioning-reserved in read(); user
        # values restrict the file's logical extent instead. An int
        # skiprows drops leading physical lines (pandas semantics); a
        # list drops those specific physical lines.
        user_skip = self._config.pop('skiprows', 0)
        user_nrows = self._config.pop('nrows', None)
        self._config.setdefault('comment', '#')
        if delim_whitespace:
            self._config.setdefault('sep', r'\s+')

        # one scan recording only the NON-data line offsets (comments,
        # blanks, user-skipped): logical->physical row mapping is then
        # O(#non-data-lines) memory via searchsorted, not one entry
        # per data row
        comment = self._config['comment']
        comment_b = comment.encode() if comment is not None else None
        skip_set = set() if np.isscalar(user_skip) else \
            set(int(i) for i in user_skip)
        skip_n = int(user_skip) if np.isscalar(user_skip) else 0
        bad = []
        total = 0
        first_line = None
        with open(path, 'rb') as ff:
            for i, line in enumerate(ff):
                total += 1
                if (i < skip_n or i in skip_set
                        or not line.strip()
                        or (comment_b is not None
                            and line.lstrip().startswith(comment_b))):
                    bad.append(i)
                elif first_line is None:
                    first_line = line
        self._bad_lines = np.asarray(bad, dtype='i8')
        self.size = total - len(bad)
        # the name list must cover the file's columns exactly
        # (reference: pandas raises through CSVFile on a mismatch).
        # Parse the first data line with pandas ITSELF — the same
        # sep/comment/quoting rules read() uses — so the count cannot
        # diverge from the real parser (a hand tokenizer mishandles
        # inline comments, literal-vs-regex seps, empty fields)
        if self.size > 0 and first_line is not None:
            import io as _io
            cfg1 = {k: v for k, v in self._config.items()
                    if k != 'skiprows'}
            df1 = pd.read_csv(_io.BytesIO(first_line), header=None,
                              nrows=1, **cfg1)
            nf = df1.shape[1]
            if nf != len(self._all_names):
                raise ValueError(
                    "file has %d columns but %d names given"
                    % (nf, len(self._all_names)))
        if user_nrows is not None:
            self.size = min(self.size, int(user_nrows))
        if skip_set:
            # specific-line skips are not forwarded to pandas (they
            # were consumed here); re-add as comment-free config
            self._config['skiprows'] = sorted(skip_set)

    def _phys(self, row):
        """Physical line index of logical data row ``row``."""
        p = int(row)
        while True:
            nb = int(np.searchsorted(self._bad_lines, p, side='right'))
            p2 = int(row) + nb
            if p2 == p:
                return p
            p = p2

    def read(self, columns, start, stop, step=1):
        if step == 0:
            raise ValueError("step must be nonzero")
        idx = np.arange(start, stop, step)
        out = self._empty(columns, len(idx))
        if idx.size == 0:
            return out
        lo, hi = int(idx.min()), int(idx.max()) + 1
        if not (0 <= lo and hi <= self.size):
            raise IndexError(
                "row range [%d, %d) outside file of size %d"
                % (lo, hi, self.size))
        cfg = dict(self._config)
        extra_skip = cfg.pop('skiprows', [])
        phys_lo = self._phys(lo)
        skiprows = sorted(set([j for j in extra_skip if j >= phys_lo])
                          | set(range(phys_lo)))
        import pandas as pd
        df = pd.read_csv(
            self.path, names=list(self._all_names), header=None,
            skiprows=skiprows,
            nrows=hi - lo,  # pandas nrows counts PARSED rows
            usecols=list(self._names), **cfg)
        for col in columns:
            vals = df[col].to_numpy()
            out[col] = vals[idx - lo].astype(self.dtype[col])
        return out
