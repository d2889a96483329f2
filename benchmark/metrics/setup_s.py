"""Set-up seconds: process start to the first timed step or frame
(imports, kernel loads, building the model, weights, warm-up), host clock."""


def read(res):
    return res["setup_s"]
