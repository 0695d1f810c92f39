"""setup_s: seconds from the process's start to the first timed call
(imports, model, kernel emission and load, reset, warm-up calls)."""


def read(record):
    return record["setup_s"]
