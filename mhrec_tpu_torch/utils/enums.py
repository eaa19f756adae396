"""Input/evaluator type enums (reference REC/utils/enum_type.py surface)."""

from enum import Enum


class InputType(Enum):
    PAIR = 1
    SEQ = 2
    AUGSEQ = 3


class EvaluatorType(Enum):
    RANKING = 1
    VALUE = 2
