"""train.data_ms: mean host milliseconds of one next() of the data
pipeline's iterator (DataPipeline.batches: mel rows, collate) in the traced
epoch, timed between the pipeline and the loop's prefetch thread."""


def read(record):
    if record.get("driver") != "train" or not record.get("data_ms"):
        return None
    return sum(record["data_ms"]) / len(record["data_ms"])
