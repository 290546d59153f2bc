"""Exception hierarchy mirroring zlib return codes (zlib-ng.h.in:180-188).

Z_DATA_ERROR  -> DataError      (corrupt/invalid stream; .msg matches zlib strings)
Z_STREAM_ERROR-> StreamError    (invalid parameters / inconsistent state)
Z_BUF_ERROR   -> BufError       (no progress possible; never fatal)
Z_NEED_DICT   -> NeedDictError  (preset dictionary required)
Z_MEM_ERROR   -> MemoryError    (builtin)
"""


class Error(Exception):
    msg = ""


class DataError(Error, ValueError):
    def __init__(self, msg: str = "data error"):
        super().__init__(msg)
        self.msg = msg


class StreamError(Error, ValueError):
    def __init__(self, msg: str = "stream error"):
        super().__init__(msg)
        self.msg = msg


class BufError(Error):
    def __init__(self, msg: str = "buffer error"):
        super().__init__(msg)
        self.msg = msg


class NeedDictError(Error):
    def __init__(self, adler: int = 0):
        super().__init__("need dictionary")
        self.msg = "need dictionary"
        self.adler = adler
