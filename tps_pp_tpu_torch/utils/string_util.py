"""String utilities (copy of ``tps_pp_tpu/utils/string_util.py``, the
reference's ``mmocr/utils/string_util.py:1-36``)."""


class StringStrip:
    """Strip leading and/or trailing characters from annotation strings.

    ``strip_pos``: 'both' | 'left' | 'right'; ``strip_str``: the characters
    to remove (None: whitespace).
    """

    def __init__(self, strip=True, strip_pos='both', strip_str=None):
        if not isinstance(strip, bool) or strip_pos not in (
                'both', 'left', 'right') or not (
                strip_str is None or isinstance(strip_str, str)):
            raise ValueError(f'StringStrip: strip={strip!r}, '
                             f'strip_pos={strip_pos!r}, '
                             f'strip_str={strip_str!r}')
        self.strip = strip
        self.strip_pos = strip_pos
        self.strip_str = strip_str

    def __call__(self, in_str):
        if not self.strip:
            return in_str
        if self.strip_pos == 'left':
            return in_str.lstrip(self.strip_str)
        if self.strip_pos == 'right':
            return in_str.rstrip(self.strip_str)
        return in_str.strip(self.strip_str)
