"""The session's error type, shared by the modules below ``api``."""


class MlisError(Exception):
    """Error with a negative code matching MLIS_ErrCode."""
    E_UNKNOWN = -1
    E_UNK_OPT = -3
    E_OPT_VALUE = -4
    E_PROMPT_PARSE = -5
    E_FILE_NOT_FOUND = -6
    E_NAN = -7
    E_IMAGE = -8

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
