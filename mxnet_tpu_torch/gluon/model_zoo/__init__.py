"""Model zoo of the port: BERT, the vision ResNets and the language
models (the LSTM LM and the GPT-style ``TransformerLM``)."""
from . import bert, language_model, vision
from .bert import BERTForPretraining, BERTModel, bert_12_768_12, \
    bert_24_1024_16, get_bert
from .language_model import StandardRNNLM, TransformerLM, gpt_lm, \
    standard_lstm_lm_200, standard_lstm_lm_650, standard_lstm_lm_1500
from .vision import get_model

__all__ = ["vision", "bert", "language_model", "get_model", "get_bert",
           "BERTModel", "BERTForPretraining", "bert_12_768_12",
           "bert_24_1024_16", "StandardRNNLM", "TransformerLM", "gpt_lm",
           "standard_lstm_lm_200", "standard_lstm_lm_650",
           "standard_lstm_lm_1500"]
