"""Process start to the window's opening."""


def read(record):
    return record["setup_s"]
