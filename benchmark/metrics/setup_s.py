"""setup_s: seconds from process start to the first timed step (import,
kernel library load, corpus, weights, DDI or load, the checked steps,
warm-up), host clock."""


def read(record):
    return record.get("setup_s")
