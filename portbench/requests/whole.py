"""Request kind `whole`: every request is the whole data."""


def sizes(params: dict, n_data: int) -> list:
    """The request sizes of one cycle, in bytes."""
    return [n_data]
