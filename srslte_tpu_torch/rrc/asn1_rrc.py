"""36.331 RRC message schemas (UNALIGNED PER) — attach-flow + SIB subset.

Reference behavior: the generated codecs under lib/src/asn1/rrc/ (headers
lib/include/srsran/asn1/rrc/*.h document the same field lists and value
ranges).  Schemas below transcribe the 36.331 ASN.1 for the messages the
stack uses: UL/DL-CCCH, the attach-flow UL/DL-DCCH messages, measurement
reports, and BCCH (SIB1 + SIB2).  Byte-exactness is proven against the
reference's committed test vectors (lib/test/asn1/srsran_asn1_rrc_*_test.cc)
and against the off-air SIB payloads decoded from
lib/src/phy/phch/test/signal.1.92M.amar.dat.

Values are plain Python: SEQUENCE -> dict, CHOICE -> (name, value),
ENUMERATED -> name string, INTEGER -> int, BIT STRING -> int (fixed size).
"""

from __future__ import annotations

from .per import (BitReader, BitWriter, Bool, Choice, Contained, Enum, F,
                  Int, Null, OctStr, SeqOf, BitStr, choice, enum, seq)

# ---------------------------------------------------------------- common IEs

_spares = lambda n: [f"spare{n - i}" for i in range(n)]

T_POLL_RETX = enum(*[f"ms{5*(i+1)}" for i in range(50)],
                   "ms300", "ms350", "ms400", "ms450", "ms500", *_spares(9))
POLL_PDU = enum("p4", "p8", "p16", "p32", "p64", "p128", "p256", "pInfinity")
POLL_BYTE = enum("kB25", "kB50", "kB75", "kB100", "kB125", "kB250", "kB375",
                 "kB500", "kB750", "kB1000", "kB1250", "kB1500", "kB2000",
                 "kB3000", "kBinfinity", "spare1")
MAX_RETX = enum("t1", "t2", "t3", "t4", "t6", "t8", "t16", "t32")
T_REORDERING = enum(*[f"ms{5*i}" for i in range(21)],
                    *[f"ms{110+10*i}" for i in range(10)], "spare1")
T_STATUS_PROHIBIT = enum(*[f"ms{5*i}" for i in range(51)],
                         "ms300", "ms350", "ms400", "ms450", "ms500",
                         *_spares(8))
SN_FIELD_LEN = enum("size5", "size10")

PLMN_IDENTITY = seq(
    F("mcc", SeqOf(Int(0, 9), 3, 3), optional=True),
    F("mnc", SeqOf(Int(0, 9), 2, 3)))


UL_AM_RLC = seq(F("t_poll_retx", T_POLL_RETX),
                F("poll_pdu", POLL_PDU),
                F("poll_byte", POLL_BYTE),
                F("max_retx_thres", MAX_RETX))
DL_AM_RLC = seq(F("t_reordering", T_REORDERING),
                F("t_status_prohibit", T_STATUS_PROHIBIT))
UL_UM_RLC = seq(F("sn_field_len", SN_FIELD_LEN))
DL_UM_RLC = seq(F("sn_field_len", SN_FIELD_LEN),
                F("t_reordering", T_REORDERING))

RLC_CONFIG = choice(
    ("am", seq(F("ul_am_rlc", UL_AM_RLC), F("dl_am_rlc", DL_AM_RLC))),
    ("um_bi_dir", seq(F("ul_um_rlc", UL_UM_RLC), F("dl_um_rlc", DL_UM_RLC))),
    ("um_uni_dir_ul", seq(F("ul_um_rlc", UL_UM_RLC))),
    ("um_uni_dir_dl", seq(F("dl_um_rlc", DL_UM_RLC))),
    ext=True)

LOGICAL_CH_CONFIG = seq(
    F("ul_specific_params",
      seq(F("prio", Int(1, 16)),
          F("prioritised_bit_rate",
            enum("kBps0", "kBps8", "kBps16", "kBps32", "kBps64", "kBps128",
                 "kBps256", "infinity", "kBps512_v1020", "kBps1024_v1020",
                 "kBps2048_v1020", *_spares(5))),
          F("bucket_size_dur",
            enum("ms50", "ms100", "ms150", "ms300", "ms500", "ms1000",
                 "spare2", "spare1")),
          F("lc_ch_group", Int(0, 3), optional=True)),
      optional=True),
    ext=True)

SRB_TO_ADD_MOD = seq(
    F("srb_id", Int(1, 2)),
    F("rlc_cfg", choice(("explicit_value", RLC_CONFIG),
                        ("default_value", Null())), optional=True),
    F("lc_ch_cfg", choice(("explicit_value", LOGICAL_CH_CONFIG),
                          ("default_value", Null())), optional=True),
    ext=True)

PDCP_CONFIG = seq(
    F("discard_timer",
      enum("ms50", "ms100", "ms150", "ms300", "ms500", "ms750", "ms1500",
           "infinity"), optional=True),
    F("rlc_am", seq(F("status_report_required", Bool())), optional=True),
    F("rlc_um", seq(F("pdcp_sn_size", enum("len7bits", "len12bits"))),
      optional=True),
    F("hdr_compress",
      choice(("not_used", Null()),
             ("rohc", seq(F("max_cid", Int(1, 16383), default=15),
                          F("profiles",
                            seq(*[F(f"profile0x{p:04x}", Bool())
                                  for p in (0x0001, 0x0002, 0x0003, 0x0004,
                                            0x0006, 0x0101, 0x0102, 0x0103,
                                            0x0104)])),
                          ext=True)))),
    ext=True)

DRB_TO_ADD_MOD = seq(
    F("eps_bearer_id", Int(0, 15), optional=True),
    F("drb_id", Int(1, 32)),
    F("pdcp_cfg", PDCP_CONFIG, optional=True),
    F("rlc_cfg", RLC_CONFIG, optional=True),
    F("lc_ch_id", Int(3, 10), optional=True),
    F("lc_ch_cfg", LOGICAL_CH_CONFIG, optional=True),
    ext=True)

PHR_CONFIG = choice(
    ("release", Null()),
    ("setup", seq(F("periodic_phr_timer",
                    enum("sf10", "sf20", "sf50", "sf100", "sf200", "sf500",
                         "sf1000", "infinity")),
                  F("prohibit_phr_timer",
                    enum("sf0", "sf10", "sf20", "sf50", "sf100", "sf200",
                         "sf500", "sf1000")),
                  F("dl_pathloss_change",
                    enum("dB1", "dB3", "dB6", "infinity")))))

DRX_CONFIG = choice(
    ("release", Null()),
    ("setup", seq(
        F("on_dur_timer",
          enum("psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8",
               "psf10", "psf20", "psf30", "psf40", "psf50", "psf60",
               "psf80", "psf100", "psf200")),
        F("drx_inactivity_timer",
          enum("psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8",
               "psf10", "psf20", "psf30", "psf40", "psf50", "psf60",
               "psf80", "psf100", "psf200", "psf300", "psf500", "psf750",
               "psf1280", "psf1920", "psf2560", "psf0_v1020", *_spares(9))),
        F("drx_retx_timer",
          enum("psf1", "psf2", "psf4", "psf6", "psf8", "psf16", "psf24",
               "psf33")),
        F("long_drx_cycle_start_offset",
          choice(("sf10", Int(0, 9)), ("sf20", Int(0, 19)),
                 ("sf32", Int(0, 31)), ("sf40", Int(0, 39)),
                 ("sf64", Int(0, 63)), ("sf80", Int(0, 79)),
                 ("sf128", Int(0, 127)), ("sf160", Int(0, 159)),
                 ("sf256", Int(0, 255)), ("sf320", Int(0, 319)),
                 ("sf512", Int(0, 511)), ("sf640", Int(0, 639)),
                 ("sf1024", Int(0, 1023)), ("sf1280", Int(0, 1279)),
                 ("sf2048", Int(0, 2047)), ("sf2560", Int(0, 2559)))),
        F("short_drx",
          seq(F("short_drx_cycle",
                enum("sf2", "sf5", "sf8", "sf10", "sf16", "sf20", "sf32",
                     "sf40", "sf64", "sf80", "sf128", "sf160", "sf256",
                     "sf320", "sf512", "sf640")),
              F("drx_short_cycle_timer", Int(1, 16))), optional=True))))

TIME_ALIGNMENT_TIMER = enum("sf500", "sf750", "sf1280", "sf1920", "sf2560",
                            "sf5120", "sf10240", "infinity")

MAC_MAIN_CONFIG = seq(
    F("ul_sch_cfg",
      seq(F("max_harq_tx",
            enum("n1", "n2", "n3", "n4", "n5", "n6", "n7", "n8", "n10",
                 "n12", "n16", "n20", "n24", "n28", "spare2", "spare1"),
            optional=True),
          F("periodic_bsr_timer",
            enum("sf5", "sf10", "sf16", "sf20", "sf32", "sf40", "sf64",
                 "sf80", "sf128", "sf160", "sf320", "sf640", "sf1280",
                 "sf2560", "infinity", "spare1"), optional=True),
          F("retx_bsr_timer",
            enum("sf320", "sf640", "sf1280", "sf2560", "sf5120", "sf10240",
                 "spare2", "spare1")),
          F("tti_bundling", Bool())),
      optional=True),
    F("drx_cfg", DRX_CONFIG, optional=True),
    F("time_align_timer_ded", TIME_ALIGNMENT_TIMER),
    F("phr_cfg", PHR_CONFIG, optional=True),
    ext=True)

# ------------------------------------------------------- physical dedicated

PDSCH_CONFIG_DED = seq(
    F("p_a", enum("dB_6", "dB_4dot77", "dB_3", "dB_1dot77", "dB0", "dB1",
                  "dB2", "dB3")))

PUCCH_CONFIG_DED = seq(
    F("ack_nack_repeat",
      choice(("release", Null()),
             ("setup", seq(F("repeat_factor",
                             enum("n2", "n4", "n6", "spare1")),
                           F("n1_pucch_an_rep", Int(0, 2047)))))),
    F("tdd_ack_nack_feedback_mode", enum("bundling", "mux"), optional=True))

PUSCH_CONFIG_DED = seq(
    F("beta_offset_ack_idx", Int(0, 15)),
    F("beta_offset_ri_idx", Int(0, 15)),
    F("beta_offset_cqi_idx", Int(0, 15)))

FILTER_COEFFICIENT = Enum(("fc0", "fc1", "fc2", "fc3", "fc4", "fc5", "fc6",
                           "fc7", "fc8", "fc9", "fc11", "fc13", "fc15",
                           "fc17", "fc19", "spare1"), ext=True)

UL_POWER_CONTROL_DED = seq(
    F("p0_ue_pusch", Int(-8, 7)),
    F("delta_mcs_enabled", enum("en0", "en1")),
    F("accumulation_enabled", Bool()),
    F("p0_ue_pucch", Int(-8, 7)),
    F("psrs_offset", Int(0, 15)),
    F("filt_coef", FILTER_COEFFICIENT, default="fc4"))

TPC_PDCCH_CONFIG = choice(
    ("release", Null()),
    ("setup", seq(F("tpc_rnti", BitStr(16)),
                  F("tpc_idx", choice(("idx_of_format3", Int(1, 15)),
                                      ("idx_of_format3a", Int(1, 31)))))))

CQI_REPORT_PERIODIC = choice(
    ("release", Null()),
    ("setup", seq(
        F("cqi_pucch_res_idx", Int(0, 1185)),
        F("cqi_pmi_cfg_idx", Int(0, 1023)),
        F("cqi_format_ind_periodic",
          choice(("wideband_cqi", Null()),
                 ("subband_cqi", seq(F("k", Int(1, 4)))))),
        F("ri_cfg_idx", Int(0, 1023), optional=True),
        F("simul_ack_nack_and_cqi", Bool()))))

CQI_REPORT_CONFIG = seq(
    F("cqi_report_mode_aperiodic",
      enum("rm12", "rm20", "rm22", "rm30", "rm31", "spare3", "spare2",
           "spare1"), optional=True),
    F("nom_pdsch_rs_epre_offset", Int(-1, 6)),
    F("cqi_report_periodic", CQI_REPORT_PERIODIC, optional=True))

SRS_UL_CONFIG_DED = choice(
    ("release", Null()),
    ("setup", seq(F("srs_bw", enum("bw0", "bw1", "bw2", "bw3")),
                  F("srs_hop_bw", enum("hbw0", "hbw1", "hbw2", "hbw3")),
                  F("freq_domain_position", Int(0, 23)),
                  F("dur", Bool()),
                  F("srs_cfg_idx", Int(0, 1023)),
                  F("tx_comb", Int(0, 1)),
                  F("cyclic_shift", enum("cs0", "cs1", "cs2", "cs3", "cs4",
                                         "cs5", "cs6", "cs7")))))

ANTENNA_INFO_DED = seq(
    F("tx_mode", enum("tm1", "tm2", "tm3", "tm4", "tm5", "tm6", "tm7",
                      "tm8_v920")),
    F("codebook_subset_restrict",
      choice(("n2_tx_ant_tm3", BitStr(2)), ("n4_tx_ant_tm3", BitStr(4)),
             ("n2_tx_ant_tm4", BitStr(6)), ("n4_tx_ant_tm4", BitStr(64)),
             ("n2_tx_ant_tm5", BitStr(4)), ("n4_tx_ant_tm5", BitStr(16)),
             ("n2_tx_ant_tm6", BitStr(4)), ("n4_tx_ant_tm6", BitStr(16))),
      optional=True),
    F("ue_tx_ant_sel", choice(("release", Null()),
                              ("setup", enum("closed_loop", "open_loop")))))

SCHEDULING_REQUEST_CONFIG = choice(
    ("release", Null()),
    ("setup", seq(F("sr_pucch_res_idx", Int(0, 2047)),
                  F("sr_cfg_idx", Int(0, 157)),
                  F("dsr_trans_max",
                    enum("n4", "n8", "n16", "n32", "n64", "spare3",
                         "spare2", "spare1")))))

PHYSICAL_CONFIG_DED = seq(
    F("pdsch_cfg_ded", PDSCH_CONFIG_DED, optional=True),
    F("pucch_cfg_ded", PUCCH_CONFIG_DED, optional=True),
    F("pusch_cfg_ded", PUSCH_CONFIG_DED, optional=True),
    F("ul_pwr_ctrl_ded", UL_POWER_CONTROL_DED, optional=True),
    F("tpc_pdcch_cfg_pucch", TPC_PDCCH_CONFIG, optional=True),
    F("tpc_pdcch_cfg_pusch", TPC_PDCCH_CONFIG, optional=True),
    F("cqi_report_cfg", CQI_REPORT_CONFIG, optional=True),
    F("srs_ul_cfg_ded", SRS_UL_CONFIG_DED, optional=True),
    F("ant_info", choice(("explicit_value", ANTENNA_INFO_DED),
                         ("default_value", Null())), optional=True),
    F("sched_request_cfg", SCHEDULING_REQUEST_CONFIG, optional=True),
    ext=True)

SPS_CONFIG = seq(
    F("semi_persist_sched_c_rnti", BitStr(16), optional=True),
    F("sps_cfg_dl", OctStr(), optional=True),   # unused by the stack
    F("sps_cfg_ul", OctStr(), optional=True))

RADIO_RESOURCE_CONFIG_DED = seq(
    F("srb_to_add_mod_list", SeqOf(SRB_TO_ADD_MOD, 1, 2), optional=True),
    F("drb_to_add_mod_list", SeqOf(DRB_TO_ADD_MOD, 1, 11), optional=True),
    F("drb_to_release_list", SeqOf(Int(1, 32), 1, 11), optional=True),
    F("mac_main_cfg", choice(("explicit_value", MAC_MAIN_CONFIG),
                             ("default_value", Null())), optional=True),
    F("sps_cfg", SPS_CONFIG, optional=True),
    F("phys_cfg_ded", PHYSICAL_CONFIG_DED, optional=True),
    ext=True)

# ------------------------------------------------------------------ UL-CCCH

S_TMSI = seq(F("mmec", BitStr(8)), F("m_tmsi", BitStr(32)))

RRC_CONNECTION_REQUEST = seq(
    F("crit_exts", choice(
        ("rrc_conn_request_r8",
         seq(F("ue_id", choice(("s_tmsi", S_TMSI),
                               ("random_value", BitStr(40)))),
             F("establishment_cause",
               enum("emergency", "high_prio_access", "mt_access",
                    "mo_sig", "mo_data", "delay_tolerant_access_v1020",
                    "mo_voice_call_v1280", "spare1")),
             F("spare", BitStr(1)))),
        ("crit_exts_future", seq()))))

RRC_CONNECTION_REEST_REQUEST = seq(
    F("crit_exts", choice(
        ("rrc_conn_reest_request_r8",
         seq(F("ue_id", seq(F("c_rnti", BitStr(16)),
                            F("pci", Int(0, 503)),
                            F("short_mac_i", BitStr(16)))),
             F("reest_cause", enum("recfg_fail", "ho_fail", "other_fail",
                                   "spare1")),
             F("spare", BitStr(2)))),
        ("crit_exts_future", seq()))))

UL_CCCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(("rrc_conn_reest_request", RRC_CONNECTION_REEST_REQUEST),
                  ("rrc_conn_request", RRC_CONNECTION_REQUEST))),
    ("msg_class_ext", seq()))))

# ------------------------------------------------------------------ DL-CCCH

_crit_ext_c1 = lambda name, r8, nspare=7: choice(
    ("c1", choice((name, r8), *[(s, Null()) for s in _spares(nspare)])),
    ("crit_exts_future", seq()))

RRC_CONNECTION_SETUP = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", _crit_ext_c1(
        "rrc_conn_setup_r8",
        seq(F("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DED),
            F("non_crit_ext", seq(), optional=True)))))

RRC_CONNECTION_REJECT = seq(
    F("crit_exts", _crit_ext_c1(
        "rrc_conn_reject_r8",
        seq(F("wait_time", Int(1, 16)),
            F("non_crit_ext", seq(), optional=True)), nspare=3)))

RRC_CONNECTION_REESTABLISHMENT = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", _crit_ext_c1(
        "rrc_conn_reest_r8",
        seq(F("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DED),
            F("next_hop_chaining_count", Int(0, 7)),
            F("non_crit_ext", seq(), optional=True)))))

RRC_CONNECTION_REESTABLISHMENT_REJECT = seq(
    F("crit_exts", choice(
        ("rrc_conn_reest_reject_r8", seq(F("non_crit_ext", seq(),
                                           optional=True))),
        ("crit_exts_future", seq()))))

DL_CCCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(("rrc_conn_reest", RRC_CONNECTION_REESTABLISHMENT),
                  ("rrc_conn_reest_reject",
                   RRC_CONNECTION_REESTABLISHMENT_REJECT),
                  ("rrc_conn_reject", RRC_CONNECTION_REJECT),
                  ("rrc_conn_setup", RRC_CONNECTION_SETUP))),
    ("msg_class_ext", seq()))))

# ------------------------------------------------------------------ UL-DCCH

RRC_CONNECTION_SETUP_COMPLETE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("c1", choice(
            ("rrc_conn_setup_complete_r8",
             seq(F("sel_plmn_id", Int(1, 6)),
                 F("registered_mme",
                   seq(F("plmn_id", OctStr(), optional=True),
                       F("mmegi", BitStr(16)),
                       F("mmec", BitStr(8))), optional=True),
                 F("ded_info_nas", OctStr()),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(3)])),
        ("crit_exts_future", seq()))))

SECURITY_MODE_COMPLETE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("security_mode_complete_r8",
         seq(F("non_crit_ext", seq(), optional=True))),
        ("crit_exts_future", seq()))))

SECURITY_MODE_FAILURE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("security_mode_fail_r8",
         seq(F("non_crit_ext", seq(), optional=True))),
        ("crit_exts_future", seq()))))

UL_INFORMATION_TRANSFER = seq(
    F("crit_exts", choice(
        ("c1", choice(
            ("ul_info_transfer_r8",
             seq(F("ded_info_type",
                   choice(("ded_info_nas", OctStr()),
                          ("ded_info_cdma2000_1xrtt", OctStr()),
                          ("ded_info_cdma2000_hrpd", OctStr()))),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(3)])),
        ("crit_exts_future", seq()))))

RRC_CONNECTION_RECONFIGURATION_COMPLETE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("rrc_conn_recfg_complete_r8",
         seq(F("non_crit_ext", seq(), optional=True))),
        ("crit_exts_future", seq()))))

RRC_CONNECTION_REESTABLISHMENT_COMPLETE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("rrc_conn_reest_complete_r8",
         seq(F("non_crit_ext", seq(), optional=True))),
        ("crit_exts_future", seq()))))

# measurement results (36.331 5.5.5)
RSRP_RANGE = Int(0, 97)
RSRQ_RANGE = Int(0, 34)

MEAS_RESULT_EUTRA = seq(
    F("pci", Int(0, 503)),
    F("cgi_info", seq(F("cell_global_id",
                        seq(F("plmn_id", PLMN_IDENTITY),
                            F("cell_id", BitStr(28)))),
                      F("tac", BitStr(16)),
                      F("plmn_id_list", SeqOf(PLMN_IDENTITY, 1, 5),
                        optional=True)), optional=True),
    F("meas_result", seq(F("rsrp_result", RSRP_RANGE, optional=True),
                         F("rsrq_result", RSRQ_RANGE, optional=True),
                         ext=True)))

MEAS_RESULTS = seq(
    F("meas_id", Int(1, 32)),
    F("meas_result_pcell", seq(F("rsrp_result", RSRP_RANGE),
                               F("rsrq_result", RSRQ_RANGE))),
    F("meas_result_neigh_cells",
      choice(("meas_result_list_eutra", SeqOf(MEAS_RESULT_EUTRA, 1, 8)),
             ("meas_result_list_utra", OctStr()),
             ("meas_result_list_geran", OctStr()),
             ("meas_results_cdma2000", OctStr()), ext=True),
      optional=True),
    ext=True)

MEASUREMENT_REPORT = seq(
    F("crit_exts", choice(
        ("c1", choice(
            ("meas_report_r8",
             seq(F("meas_results", MEAS_RESULTS),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(7)])),
        ("crit_exts_future", seq()))))

UL_DCCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(
        ("csfb_params_request_cdma2000", seq()),
        ("meas_report", MEASUREMENT_REPORT),
        ("rrc_conn_recfg_complete", RRC_CONNECTION_RECONFIGURATION_COMPLETE),
        ("rrc_conn_reest_complete", RRC_CONNECTION_REESTABLISHMENT_COMPLETE),
        ("rrc_conn_setup_complete", RRC_CONNECTION_SETUP_COMPLETE),
        ("security_mode_complete", SECURITY_MODE_COMPLETE),
        ("security_mode_fail", SECURITY_MODE_FAILURE),
        ("ue_cap_info", seq()),
        ("ul_ho_prep_transfer", seq()),
        ("ul_info_transfer", UL_INFORMATION_TRANSFER),
        ("counter_check_resp", seq()),
        ("ue_info_resp_r9", seq()),
        ("proximity_ind_r9", seq()),
        ("rn_recfg_complete_r10", seq()),
        ("mbms_count_resp_r10", seq()),
        ("inter_freq_rstd_meas_ind_r10", seq()))),
    ("msg_class_ext", seq()))))

# ------------------------------------------------------------------ DL-DCCH

SECURITY_ALGORITHM_CONFIG = seq(
    F("ciphering_algorithm",
      Enum(("eea0", "eea1", "eea2", "eea3_v1130", "spare4", "spare3",
            "spare2", "spare1"), ext=True)),
    F("integrity_prot_algorithm",
      Enum(("eia0_v920", "eia1", "eia2", "eia3_v1130", "spare4", "spare3",
            "spare2", "spare1"), ext=True)))

SECURITY_MODE_COMMAND = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("c1", choice(
            ("security_mode_cmd_r8",
             seq(F("security_cfg_smc",
                   seq(F("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG),
                       ext=True)),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(3)])),
        ("crit_exts_future", seq()))))

DL_INFORMATION_TRANSFER = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("c1", choice(
            ("dl_info_transfer_r8",
             seq(F("ded_info_type",
                   choice(("ded_info_nas", OctStr()),
                          ("ded_info_cdma2000_1xrtt", OctStr()),
                          ("ded_info_cdma2000_hrpd", OctStr()))),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(3)])),
        ("crit_exts_future", seq()))))

RRC_CONNECTION_RELEASE = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("c1", choice(
            ("rrc_conn_release_r8",
             seq(F("release_cause",
                   enum("load_balancing_ta_urequired", "other",
                        "cs_fallback_high_prio_v1020", "rrc_suspend_v1320")),
                 F("redirected_carrier_info",
                   choice(("eutra", Int(0, 65535)),
                          ("geran", seq(ext=True)),
                          ("utra_fdd", Int(0, 16383)),
                          ("utra_tdd", Int(0, 16383)),
                          ("cdma2000_hrpd", seq(ext=True)),
                          ("cdma2000_1xrtt", seq(ext=True)), ext=True),
                   optional=True),
                 F("idle_mode_mob_ctrl_info", OctStr(), optional=True),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(3)])),
        ("crit_exts_future", seq()))))

# --------------------------------------------------------------------- PCCH

PAGING_UE_IDENTITY = choice(
    ("s_tmsi", S_TMSI),
    ("imsi", SeqOf(Int(0, 9), 6, 21)), ext=True)

PAGING_RECORD = seq(
    F("ue_id", PAGING_UE_IDENTITY),
    F("cn_domain", enum("ps", "cs")),
    ext=True)

PAGING = seq(
    F("paging_record_list", SeqOf(PAGING_RECORD, 1, 16), optional=True),
    F("sys_info_mod", enum("true"), optional=True),
    F("etws_ind", enum("true"), optional=True),
    F("non_crit_ext", seq(), optional=True))

PCCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(("paging", PAGING))),
    ("msg_class_ext", seq()))))

# --------------------------------------------------------------------- BCCH

PLMN_IDENTITY_INFO = seq(
    F("plmn_id", PLMN_IDENTITY),
    F("cell_reserved_for_oper", enum("reserved", "not_reserved")))

SIB_TYPE = Enum(("sib_type3", "sib_type4", "sib_type5", "sib_type6",
                 "sib_type7", "sib_type8", "sib_type9", "sib_type10",
                 "sib_type11", "sib_type12_v920", "sib_type13_v920",
                 "sib_type14_v1130", "sib_type15_v1130",
                 "sib_type16_v1130", "sib_type17_v1250",
                 "sib_type18_v1250"), ext=True)

SCHEDULING_INFO = seq(
    F("si_periodicity", enum("rf8", "rf16", "rf32", "rf64", "rf128",
                             "rf256", "rf512")),
    F("sib_map_info", SeqOf(SIB_TYPE, 0, 31)))

SIB1 = seq(
    F("cell_access_related_info",
      seq(F("plmn_id_list", SeqOf(PLMN_IDENTITY_INFO, 1, 6)),
          F("tac", BitStr(16)),
          F("cell_id", BitStr(28)),
          F("cell_barred", enum("barred", "not_barred")),
          F("intra_freq_resel", enum("allowed", "not_allowed")),
          F("csg_ind", Bool()),
          F("csg_id", BitStr(27), optional=True))),
    F("cell_sel_info",
      seq(F("q_rx_lev_min", Int(-70, -22)),
          F("q_rx_lev_min_offset", Int(1, 8), optional=True))),
    F("p_max", Int(-30, 33), optional=True),
    F("freq_band_ind", Int(1, 64)),
    F("sched_info_list", SeqOf(SCHEDULING_INFO, 1, 32)),
    F("tdd_cfg", seq(F("sf_assign", enum("sa0", "sa1", "sa2", "sa3", "sa4",
                                         "sa5", "sa6")),
                     F("special_sf_patterns",
                       enum(*[f"ssp{i}" for i in range(9)]))),
      optional=True),
    F("si_win_len", enum("ms1", "ms2", "ms5", "ms10", "ms15", "ms20",
                         "ms40")),
    F("sys_info_value_tag", Int(0, 31)),
    F("non_crit_ext", seq(), optional=True))

# ---- SIB2 (radioResourceConfigCommonSIB core) ----

RACH_CONFIG_COMMON = seq(
    F("preamb_info",
      seq(F("nof_ra_preambs",
            enum("n4", "n8", "n12", "n16", "n20", "n24", "n28", "n32",
                 "n36", "n40", "n44", "n48", "n52", "n56", "n60", "n64")),
          F("preambs_group_a_cfg",
            seq(F("size_of_ra_group_a",
                  enum("n4", "n8", "n12", "n16", "n20", "n24", "n28",
                       "n32", "n36", "n40", "n44", "n48", "n52", "n56",
                       "n60")),
                F("msg_size_group_a",
                  enum("b56", "b144", "b208", "b256")),
                F("msg_pwr_offset_group_b",
                  enum("minusinfinity", "dB0", "dB5", "dB8", "dB10",
                       "dB12", "dB15", "dB18")),
                ext=True), optional=True))),
    F("pwr_ramp_params",
      seq(F("pwr_ramp_step", enum("dB0", "dB2", "dB4", "dB6")),
          F("preamb_init_rx_target_pwr",
            enum(*[f"dBm_{120 - 2*i}" for i in range(16)])))),
    F("ra_supervision_info",
      seq(F("preamb_trans_max",
            enum("n3", "n4", "n5", "n6", "n7", "n8", "n10", "n20", "n50",
                 "n100", "n200")),
          F("ra_resp_win_size",
            enum("sf2", "sf3", "sf4", "sf5", "sf6", "sf7", "sf8", "sf10")),
          F("mac_contention_resolution_timer",
            enum("sf8", "sf16", "sf24", "sf32", "sf40", "sf48", "sf56",
                 "sf64")))),
    F("max_harq_msg3_tx", Int(1, 8)),
    ext=True)

BCCH_CONFIG = seq(F("mod_period_coeff", enum("n2", "n4", "n8", "n16")))
PCCH_CONFIG = seq(
    F("default_paging_cycle", enum("rf32", "rf64", "rf128", "rf256")),
    F("nb", enum("four_t", "two_t", "one_t", "half_t", "quarter_t",
                 "one_eighth_t", "one_sixteenth_t", "one_thirty_second_t")))

PRACH_CONFIG_SIB = seq(
    F("root_seq_idx", Int(0, 837)),
    F("prach_cfg_info",
      seq(F("prach_cfg_idx", Int(0, 63)),
          F("high_speed_flag", Bool()),
          F("zero_correlation_zone_cfg", Int(0, 15)),
          F("prach_freq_offset", Int(0, 94)))))

PDSCH_CONFIG_COMMON = seq(F("ref_sig_pwr", Int(-60, 50)),
                          F("p_b", Int(0, 3)))

PUSCH_CONFIG_COMMON = seq(
    F("pusch_cfg_basic",
      seq(F("n_sb", Int(1, 4)),
          F("hop_mode", enum("inter_sub_frame", "intra_and_inter_sub_frame")),
          F("pusch_hop_offset", Int(0, 98)),
          F("enable64_qam", Bool()))),
    F("ul_ref_sigs_pusch",
      seq(F("group_hop_enabled", Bool()),
          F("group_assign_pusch", Int(0, 29)),
          F("seq_hop_enabled", Bool()),
          F("cyclic_shift", Int(0, 7)))))

PUCCH_CONFIG_COMMON = seq(
    F("delta_pucch_shift", enum("ds1", "ds2", "ds3")),
    F("n_rb_cqi", Int(0, 98)),
    F("n_cs_an", Int(0, 7)),
    F("n1_pucch_an", Int(0, 2047)))

SRS_UL_CONFIG_COMMON = choice(
    ("release", Null()),
    ("setup", seq(
        F("srs_bw_cfg", enum("bw0", "bw1", "bw2", "bw3", "bw4", "bw5",
                             "bw6", "bw7")),
        F("srs_sf_cfg", enum(*[f"sc{i}" for i in range(15)], "slsc")),
        F("ack_nack_srs_simul_tx", Bool()),
        F("srs_max_up_pts", enum("true"), optional=True))))

UL_POWER_CONTROL_COMMON = seq(
    F("p0_nominal_pusch", Int(-126, 24)),
    F("alpha", enum("al0", "al04", "al05", "al06", "al07", "al08", "al09",
                    "al1")),
    F("p0_nominal_pucch", Int(-127, -96)),
    F("delta_flist_pucch",
      seq(F("delta_f_pucch_format1", enum("deltaF_2", "deltaF0", "deltaF2")),
          F("delta_f_pucch_format1b",
            enum("deltaF1", "deltaF3", "deltaF5")),
          F("delta_f_pucch_format2",
            enum("deltaF_2", "deltaF0", "deltaF1", "deltaF2")),
          F("delta_f_pucch_format2a",
            enum("deltaF_2", "deltaF0", "deltaF2")),
          F("delta_f_pucch_format2b",
            enum("deltaF_2", "deltaF0", "deltaF2")))),
    F("delta_preamb_msg3", Int(-1, 6)))

RADIO_RESOURCE_CONFIG_COMMON_SIB = seq(
    F("rach_cfg_common", RACH_CONFIG_COMMON),
    F("bcch_cfg", BCCH_CONFIG),
    F("pcch_cfg", PCCH_CONFIG),
    F("prach_cfg", PRACH_CONFIG_SIB),
    F("pdsch_cfg_common", PDSCH_CONFIG_COMMON),
    F("pusch_cfg_common", PUSCH_CONFIG_COMMON),
    F("pucch_cfg_common", PUCCH_CONFIG_COMMON),
    F("srs_ul_cfg_common", SRS_UL_CONFIG_COMMON),
    F("ul_pwr_ctrl_common", UL_POWER_CONTROL_COMMON),
    F("ul_cp_len", enum("len1", "len2")),
    ext=True)

UE_TIMERS_AND_CONSTANTS = seq(
    F("t300", enum("ms100", "ms200", "ms300", "ms400", "ms600", "ms1000",
                   "ms1500", "ms2000")),
    F("t301", enum("ms100", "ms200", "ms300", "ms400", "ms600", "ms1000",
                   "ms1500", "ms2000")),
    F("t310", enum("ms0", "ms50", "ms100", "ms200", "ms500", "ms1000",
                   "ms2000")),
    F("n310", enum("n1", "n2", "n3", "n4", "n6", "n8", "n10", "n20")),
    F("t311", enum("ms1000", "ms3000", "ms5000", "ms10000", "ms15000",
                   "ms20000", "ms30000")),
    F("n311", enum("n1", "n2", "n3", "n4", "n5", "n6", "n8", "n10")),
    ext=True)

SIB2 = seq(
    F("ac_barring_info",
      seq(F("ac_barring_for_emergency", Bool()),
          F("ac_barring_for_mo_sig", OctStr(), optional=True),
          F("ac_barring_for_mo_data", OctStr(), optional=True)),
      optional=True),
    F("rr_cfg_common", RADIO_RESOURCE_CONFIG_COMMON_SIB),
    F("ue_timers_and_consts", UE_TIMERS_AND_CONSTANTS),
    F("freq_info",
      seq(F("ul_carrier_freq", Int(0, 65535), optional=True),
          F("ul_bw", enum("n6", "n15", "n25", "n50", "n75", "n100"),
            optional=True),
          F("add_spec_emission", Int(1, 32)))),
    F("mbsfn_sf_cfg_list", SeqOf(OctStr(), 1, 8), optional=True),
    F("time_align_timer_common", TIME_ALIGNMENT_TIMER),
    ext=True)

SPEED_STATE_SCALE_FACTORS = seq(
    F("sf_medium", enum("oDot25", "oDot5", "oDot75", "lDot0")),
    F("sf_high", enum("oDot25", "oDot5", "oDot75", "lDot0")))

MOBILITY_STATE_PARAMETERS = seq(
    F("t_eval", enum("s30", "s60", "s120", "s180", "s240", "spare3",
                     "spare2", "spare1")),
    F("t_hyst_normal", enum("s30", "s60", "s120", "s180", "s240", "spare3",
                            "spare2", "spare1")),
    F("n_cell_change_medium", Int(1, 16)),
    F("n_cell_change_high", Int(1, 16)))

SIB3 = seq(
    F("cell_resel_info_common",
      seq(F("q_hyst", enum("dB0", "dB1", "dB2", "dB3", "dB4", "dB5", "dB6",
                           "dB8", "dB10", "dB12", "dB14", "dB16", "dB18",
                           "dB20", "dB22", "dB24")),
          F("speed_state_resel_pars",
            seq(F("mob_state_params", MOBILITY_STATE_PARAMETERS),
                F("q_hyst_sf",
                  seq(F("sf_medium", enum("dB_6", "dB_4", "dB_2", "dB0")),
                      F("sf_high", enum("dB_6", "dB_4", "dB_2", "dB0"))))),
            optional=True))),
    F("cell_resel_serving_freq_info",
      seq(F("s_non_intra_search", Int(0, 31), optional=True),
          F("thresh_serving_low", Int(0, 31)),
          F("cell_resel_prio", Int(0, 7)))),
    F("intra_freq_cell_resel_info",
      seq(F("q_rx_lev_min", Int(-70, -22)),
          F("p_max", Int(-30, 33), optional=True),
          F("s_intra_search", Int(0, 31), optional=True),
          F("allowed_meas_bw", enum("mbw6", "mbw15", "mbw25", "mbw50",
                                    "mbw75", "mbw100"), optional=True),
          F("presence_ant_port1", Bool()),
          F("neigh_cell_cfg", BitStr(2)),
          F("t_resel_eutra", Int(0, 7)),
          F("t_resel_eutra_sf", SPEED_STATE_SCALE_FACTORS, optional=True))),
    ext=True)

SYSTEM_INFORMATION = seq(
    F("crit_exts", choice(
        ("sys_info_r8",
         seq(F("sib_type_and_info",
               SeqOf(Choice((("sib2", SIB2),
                             ("sib3", SIB3),
                             ("sib4", seq(ext=True)),
                             ("sib5", seq(ext=True)),
                             ("sib6", seq(ext=True)),
                             ("sib7", seq(ext=True)),
                             ("sib8", seq(ext=True)),
                             ("sib9", seq(ext=True)),
                             ("sib10", seq(ext=True)),
                             ("sib11", seq(ext=True))), ext=True),
                     1, 32)),
             F("non_crit_ext", seq(), optional=True))),
        ("crit_exts_future", seq()))))

BCCH_DL_SCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(("sys_info", SYSTEM_INFORMATION),
                  ("sib_type1", SIB1))),
    ("msg_class_ext", seq()))))



# ------------------------------------------------- measurement configuration

Q_OFFSET_RANGE = enum(*[f"dB_{24-2*i}" for i in range(10)],
                      *[f"dB{'_' if v < 0 else ''}{abs(v)}" if v < 0 else f"dB{v}"
                        for v in range(-5, 6)],
                      *[f"dB{6+2*i}" for i in range(10)])

TIME_TO_TRIGGER = enum("ms0", "ms40", "ms64", "ms80", "ms100", "ms128",
                       "ms160", "ms256", "ms320", "ms480", "ms512", "ms640",
                       "ms1024", "ms1280", "ms2560", "ms5120")

THRESHOLD_EUTRA = choice(("thres_rsrp", Int(0, 97)),
                         ("thres_rsrq", Int(0, 34)))

CELLS_TO_ADD_MOD = seq(F("cell_idx", Int(1, 32)),
                       F("pci", Int(0, 503)),
                       F("cell_individual_offset", Q_OFFSET_RANGE))

MEAS_OBJECT_EUTRA = seq(
    F("carrier_freq", Int(0, 65535)),
    F("allowed_meas_bw", enum("mbw6", "mbw15", "mbw25", "mbw50", "mbw75",
                              "mbw100")),
    F("presence_ant_port1", Bool()),
    F("neigh_cell_cfg", BitStr(2)),
    F("offset_freq", Q_OFFSET_RANGE, default="dB0"),
    F("cells_to_rem_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    F("cells_to_add_mod_list", SeqOf(CELLS_TO_ADD_MOD, 1, 32),
      optional=True),
    F("black_cells_to_rem_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    F("black_cells_to_add_mod_list",
      SeqOf(seq(F("cell_idx", Int(1, 32)),
                F("pci_range", seq(F("start", Int(0, 503)),
                                   F("range",
                                     enum("n4", "n8", "n12", "n16", "n24",
                                          "n32", "n48", "n64", "n84", "n96",
                                          "n128", "n168", "n252", "n504",
                                          "spare2", "spare1"),
                                     optional=True)))), 1, 32),
      optional=True),
    F("cell_for_which_to_report_cgi", Int(0, 503), optional=True),
    ext=True)

REPORT_CONFIG_EUTRA = seq(
    F("trigger_type", choice(
        ("event", seq(
            F("event_id", choice(
                ("event_a1", seq(F("a1_thres", THRESHOLD_EUTRA))),
                ("event_a2", seq(F("a2_thres", THRESHOLD_EUTRA))),
                ("event_a3", seq(F("a3_offset", Int(-30, 30)),
                                 F("report_on_leave", Bool()))),
                ("event_a4", seq(F("a4_thres", THRESHOLD_EUTRA))),
                ("event_a5", seq(F("a5_thres1", THRESHOLD_EUTRA),
                                 F("a5_thres2", THRESHOLD_EUTRA))),
                ext=True)),
            F("hysteresis", Int(0, 30)),
            F("time_to_trigger", TIME_TO_TRIGGER))),
        ("periodical", seq(F("purpose", enum("report_strongest_cells",
                                             "report_cgi")))))),
    F("trigger_quant", enum("rsrp", "rsrq")),
    F("report_quant", enum("same_as_trigger_quant", "both")),
    F("max_report_cells", Int(1, 8)),
    F("report_interv", enum("ms120", "ms240", "ms480", "ms640", "ms1024",
                            "ms2048", "ms5120", "ms10240", "min1", "min6",
                            "min12", "min30", "min60", "spare3", "spare2",
                            "spare1")),
    F("report_amount", enum("r1", "r2", "r4", "r8", "r16", "r32", "r64",
                            "infinity")),
    ext=True)

MEAS_CONFIG = seq(
    F("meas_obj_to_rem_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    F("meas_obj_to_add_mod_list",
      SeqOf(seq(F("meas_obj_id", Int(1, 32)),
                F("meas_obj", choice(
                    ("meas_obj_eutra", MEAS_OBJECT_EUTRA),
                    ("meas_obj_utra", seq(ext=True)),
                    ("meas_obj_geran", seq(ext=True)),
                    ("meas_obj_cdma2000", seq(ext=True)), ext=True))),
            1, 32), optional=True),
    F("report_cfg_to_rem_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    F("report_cfg_to_add_mod_list",
      SeqOf(seq(F("report_cfg_id", Int(1, 32)),
                F("report_cfg", choice(
                    ("report_cfg_eutra", REPORT_CONFIG_EUTRA),
                    ("report_cfg_inter_rat", seq(ext=True))))),
            1, 32), optional=True),
    F("meas_id_to_rem_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    F("meas_id_to_add_mod_list",
      SeqOf(seq(F("meas_id", Int(1, 32)),
                F("meas_obj_id", Int(1, 32)),
                F("report_cfg_id", Int(1, 32))), 1, 32), optional=True),
    F("quant_cfg",
      seq(F("quant_cfg_eutra",
            seq(F("filt_coef_rsrp", FILTER_COEFFICIENT, default="fc4"),
                F("filt_coef_rsrq", FILTER_COEFFICIENT, default="fc4")),
            optional=True),
          F("quant_cfg_utra", seq(ext=True), optional=True),
          F("quant_cfg_geran", seq(ext=True), optional=True),
          F("quant_cfg_cdma2000", seq(ext=True), optional=True),
          ext=True), optional=True),
    F("meas_gap_cfg",
      choice(("release", Null()),
             ("setup", seq(F("gap_offset",
                             choice(("gp0", Int(0, 39)), ("gp1", Int(0, 79)),
                                    ext=True))))), optional=True),
    F("s_measure", Int(0, 97), optional=True),
    F("pre_regist_info_hrpd",
      seq(F("pre_regist_allowed", Bool()),
          F("pre_regist_zone_id", Int(0, 255), optional=True),
          F("secondary_pre_regist_zone_id_list", SeqOf(Int(0, 255), 1, 2),
            optional=True)), optional=True),
    F("speed_state_pars",
      choice(("release", Null()),
             ("setup", seq(
                 F("mob_state_params",
                   seq(F("t_eval", enum("s30", "s60", "s120", "s180",
                                        "s240", "spare3", "spare2",
                                        "spare1")),
                       F("t_hyst_normal", enum("s30", "s60", "s120", "s180",
                                               "s240", "spare3", "spare2",
                                               "spare1")),
                       F("n_cell_change_medium", Int(1, 16)),
                       F("n_cell_change_high", Int(1, 16)))),
                 F("time_to_trigger_sf",
                   seq(F("sf_medium", enum("oDot25", "oDot5", "oDot75",
                                           "lDot0")),
                       F("sf_high", enum("oDot25", "oDot5", "oDot75",
                                         "lDot0"))))))), optional=True),
    ext=True)

SECURITY_CONFIG_HO = seq(
    F("ho_type", choice(
        ("intra_lte",
         seq(F("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG,
               optional=True),
             F("key_change_ind", Bool()),
             F("next_hop_chaining_count", Int(0, 7)))),
        ("inter_rat",
         seq(F("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG),
             F("nas_security_param_to_eutra", OctStr(6, 6)))))),
    ext=True)

# mobility control (handover command core, 36.331 6.3.4)
CARRIER_FREQ_EUTRA = seq(F("dl_carrier_freq", Int(0, 65535)),
                         F("ul_carrier_freq", Int(0, 65535), optional=True))
CARRIER_BANDWIDTH_EUTRA = seq(
    F("dl_bw", enum("n6", "n15", "n25", "n50", "n75", "n100", *_spares(10))),
    F("ul_bw", enum("n6", "n15", "n25", "n50", "n75", "n100", *_spares(10)),
      optional=True))

MOBILITY_CONTROL_INFO = seq(
    F("target_pci", Int(0, 503)),
    F("carrier_freq", CARRIER_FREQ_EUTRA, optional=True),
    F("carrier_bw", CARRIER_BANDWIDTH_EUTRA, optional=True),
    F("add_spec_emission", Int(1, 32), optional=True),
    F("t304", enum("ms50", "ms100", "ms150", "ms200", "ms500", "ms1000",
                   "ms2000", "spare1")),
    F("new_ue_id", BitStr(16)),
    # RadioResourceConfigCommon (handover variant): every field optional —
    # an empty dict keeps the source-cell common configuration
    F("rr_cfg_common",
      seq(F("rach_cfg_common", RACH_CONFIG_COMMON, optional=True),
          F("prach_cfg",
            seq(F("root_seq_idx", Int(0, 837)),
                F("prach_cfg_info",
                  seq(F("prach_cfg_idx", Int(0, 63)),
                      F("high_speed_flag", Bool()),
                      F("zero_correlation_zone_cfg", Int(0, 15)),
                      F("prach_freq_offset", Int(0, 94))), optional=True))),
          F("pdsch_cfg_common", PDSCH_CONFIG_COMMON, optional=True),
          F("pusch_cfg_common", PUSCH_CONFIG_COMMON),
          F("phich_cfg",
            seq(F("phich_dur", enum("normal", "extended")),
                F("phich_res", enum("one_sixth", "half", "one", "two"))),
            optional=True),
          F("pucch_cfg_common", PUCCH_CONFIG_COMMON, optional=True),
          F("srs_ul_cfg_common", SRS_UL_CONFIG_COMMON, optional=True),
          F("ul_pwr_ctrl_common", UL_POWER_CONTROL_COMMON, optional=True),
          F("ant_info_common",
            seq(F("ant_ports_count", enum("an1", "an2", "an4", "spare1"))),
            optional=True),
          F("p_max", Int(-30, 33), optional=True),
          F("tdd_cfg",
            seq(F("sf_assign", enum("sa0", "sa1", "sa2", "sa3", "sa4",
                                    "sa5", "sa6")),
                F("special_sf_patterns",
                  enum(*[f"ssp{i}" for i in range(9)]))), optional=True),
          F("ul_cp_len", enum("len1", "len2")),
          ext=True)),
    F("rach_cfg_ded", seq(F("ra_preamb_idx", Int(0, 63)),
                          F("ra_prach_mask_idx", Int(0, 15))),
      optional=True),
    ext=True)

RRC_CONNECTION_RECONFIGURATION = seq(
    F("rrc_transaction_id", Int(0, 3)),
    F("crit_exts", choice(
        ("c1", choice(
            ("rrc_conn_recfg_r8",
             seq(F("meas_cfg", MEAS_CONFIG, optional=True),
                 F("mob_ctrl_info", MOBILITY_CONTROL_INFO, optional=True),
                 F("ded_info_nas_list", SeqOf(OctStr(), 1, 11),
                   optional=True),
                 F("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DED, optional=True),
                 F("security_cfg_ho", SECURITY_CONFIG_HO, optional=True),
                 F("non_crit_ext", seq(), optional=True))),
            *[(s, Null()) for s in _spares(7)])),
        ("crit_exts_future", seq()))))

DL_DCCH_MESSAGE = seq(F("msg", choice(
    ("c1", choice(
        ("csfb_params_resp_cdma2000", seq()),
        ("dl_info_transfer", DL_INFORMATION_TRANSFER),
        ("ho_from_eutra_prep_request", seq()),
        ("mob_from_eutra_cmd", seq()),
        ("rrc_conn_recfg", RRC_CONNECTION_RECONFIGURATION),
        ("rrc_conn_release", RRC_CONNECTION_RELEASE),
        ("security_mode_cmd", SECURITY_MODE_COMMAND),
        ("ue_cap_enquiry", seq()),
        ("counter_check", seq()),
        ("ue_info_request_r9", seq()),
        ("logged_meas_cfg_r10", seq()),
        ("rn_recfg_r10", seq()),
        ("spare4", Null()), ("spare3", Null()), ("spare2", Null()),
        ("spare1", Null()))),
    ("msg_class_ext", seq()))))

